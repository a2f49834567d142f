"""Train an LM with the port's training stack: FFD-packed data, AdamW,
checkpoints in the reference's layout and crash-safe resume (the
counterpart of ``examples/train_lm.py``).

Runs on the card unless ``--device cpu``.  ``--preset smoke`` trains a
1.3 M-parameter model in seconds; ``--arch`` takes any registry config instead (e.g.
``stablelm-1.6b``).  A rerun with the same ``--ckpt-dir`` resumes from the
latest checkpoint there: weights, moments, step and the data cursor.

Run:  PYTHONPATH=src python -m repro_torch.launch.train_lm --preset smoke \\
          --device cpu
      PYTHONPATH=src python -m repro_torch.launch.train_lm --preset 100m \\
          --steps 300
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.configs import ArchConfig, get_config
from repro_torch.data import PackedLMDataset
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.train import AdamWConfig, CheckpointManager, init_state, \
    make_train_step, state_from_reference, state_to_reference

__all__ = ["PRESETS", "Trainer", "train", "main"]

PRESETS = {
    "smoke": ArchConfig(
        name="train-smoke", family="dense", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=512,
        vocab_size=2048),
    "100m": ArchConfig(
        name="train-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
        vocab_size=32000),
}
# the reference example's flags; training takes the non-kernel route
FLAGS = RuntimeFlags(param_dtype="float32", compute_dtype="float32",
                     remat="none", use_pallas=False)


class Trainer:
    """One training run: a model on ``device`` (``None`` means CUDA), its
    train state, the packed data stream and, with ``ckpt_dir``, a
    checkpoint every ``ckpt_every`` steps (0: none).  When ``ckpt_dir``
    holds a checkpoint, the run resumes from the latest one: ``start`` is
    its step."""

    def __init__(self, cfg: ArchConfig, *, flags: RuntimeFlags = FLAGS,
                 opt_cfg: Optional[AdamWConfig] = None, batch: int = 4,
                 seq: int = 256, seed: int = 0, device=None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
                 keep: int = 2, microbatch: int = 1):
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.model = build_model(cfg, flags, device=device, seed=seed)
        self.dataset = PackedLMDataset(vocab_size=cfg.vocab_size,
                                       seq_len=seq, batch_size=batch,
                                       seed=seed)
        self.ckpt_every = ckpt_every
        self.mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir \
            else None
        tree, manifest = (self.mgr.restore(device=self.model.device)
                          if self.mgr else (None, None))
        if tree is None:
            self.state = init_state(self.model, self.opt_cfg)
            self.start = 0
        else:
            self.state = state_from_reference(self.model, tree)
            self.start = manifest["step"]
            self.dataset.restore(manifest["extra"]["data"])
        self.step_fn = make_train_step(self.model, self.opt_cfg,
                                       microbatch=microbatch)

    def save(self) -> str:
        step = int(self.state["step"])
        return self.mgr.save(step, state_to_reference(self.model,
                                                      self.state),
                             extra={"data": self.dataset.state()})

    def run(self, steps: int,
            log: Optional[Callable[[str], None]] = print) -> dict:
        """Train until the state's step reaches ``steps``.  Returns the
        per-step ``loss``, ``grad_norm``, ``lr`` and host ``seconds`` of
        the train step (the batch made before the clock starts; the step
        ends in reading its metrics, so it includes the device's work) and
        the steps at which checkpoints were written."""
        out = {"loss": [], "grad_norm": [], "lr": [], "seconds": [],
               "saved": []}
        it = iter(self.dataset)
        for step in range(int(self.state["step"]), steps):
            batch = next(it)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            for k in ("loss", "grad_norm", "lr"):
                out[k].append(float(metrics[k]))
            out["seconds"].append(time.perf_counter() - t0)
            if log and (step + 1) % 5 == 0:
                log(f"step {step + 1:4d}  loss {out['loss'][-1]:.4f}  "
                    f"lr {out['lr'][-1]:.2e}  gnorm "
                    f"{out['grad_norm'][-1]:.3f}  "
                    f"{out['seconds'][-1] * 1e3:.0f} ms/step")
            if self.mgr and self.ckpt_every and \
                    (step + 1) % self.ckpt_every == 0:
                self.save()
                out["saved"].append(step + 1)
        return out


def train(cfg: ArchConfig, steps: int, *,
          log: Optional[Callable[[str], None]] = print, **kw) -> dict:
    """``Trainer(cfg, **kw).run(steps, log)``, plus the trainer under
    ``'trainer'``."""
    trainer = Trainer(cfg, **kw)
    return dict(trainer.run(steps, log), trainer=trainer)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="smoke", choices=list(PRESETS))
    ap.add_argument("--arch", help="a registry config instead of a preset")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--ckpt-dir", default="build/train_lm_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.arch else PRESETS[args.preset]
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params)")
    trainer = Trainer(
        cfg, opt_cfg=AdamWConfig(peak_lr=3e-4, warmup_steps=20,
                                 total_steps=args.steps),
        batch=args.batch, seq=args.seq, device=args.device,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    if trainer.start:
        print(f"resumed from step {trainer.start}")
    losses = trainer.run(args.steps)["loss"]
    if not losses:
        print(f"nothing to do: the checkpoint is at step {trainer.start}")
        return
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
