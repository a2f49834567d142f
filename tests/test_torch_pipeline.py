"""GPipe over a process group (``repro_torch.parallel.pipeline``) against
the sequential stack and the JAX package's ``pipeline_apply``, on the CPU.

4 gloo ranks are spawned once for this file (``tests/_torch_ranks.py::
pipeline_paths``), one stage each, for ``tests/test_pipeline.py``'s case
(S 4, M 8, Bm 2, D 16, stage ``tanh(h @ w)``) and an M < S case (M 2);
S = 1 runs in this process with no group.  The reference runs in a
subprocess with 4 host devices (its mesh needs them at JAX's first
import).  Tolerance: rtol = atol = 1e-5, the reference test's.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.parallel.pipeline import bubble_fraction as ref_bubble
from repro_torch.compat import run_local_group
from repro_torch.parallel import bubble_fraction, pipeline_apply

from _torch_ranks import pipeline_paths

TOL = dict(rtol=1e-5, atol=1e-5)
S, Bm, D = 4, 2, 16


def _case(M, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(S, D, D)) / D ** 0.5).astype(np.float32)
    x = rng.normal(size=(M, Bm, D)).astype(np.float32)
    return w, x


CASES = {"m8": _case(8), "m2": _case(2, seed=1)}


def _sequential(w, x):
    y = torch.from_numpy(x)
    for s in range(w.shape[0]):
        y = torch.tanh(y @ torch.from_numpy(w[s]))
    return y.numpy()


REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.parallel.pipeline import pipeline_apply
    mesh = make_mesh((4,), ("stage",))
    data = np.load(sys.argv[1])
    out = {}
    for name in ("m8", "m2"):
        w, x = jnp.asarray(data[name + "_w"]), jnp.asarray(data[name + "_x"])
        out[name] = np.asarray(pipeline_apply(
            lambda p, h: jnp.tanh(h @ p), w, x, mesh))
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    np.savez(tmp / "in.npz", **{f"{k}_{n}": a for k, (w, x) in CASES.items()
                                for n, a in (("w", w), ("x", x))})
    env = {**os.environ, "PYTHONPATH": "src",
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    ranks = run_local_group(pipeline_paths, S, CASES)
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log
    ref = dict(np.load(tmp / "ref.npz"))
    return ranks, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_gpipe_over_four_ranks_equals_the_sequential_stack(runs, case):
    ranks, _ = runs
    want = _sequential(*CASES[case])
    for r in ranks:      # the last stage's results reach every rank
        np.testing.assert_allclose(r[case], want, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gpipe_equals_the_reference(runs, case):
    ranks, ref = runs
    np.testing.assert_allclose(ranks[0][case], ref[case], **TOL)


def test_one_stage_without_a_group():
    w, x = _case(3)
    out = pipeline_apply(lambda p, h: torch.tanh(h @ p),
                         torch.from_numpy(w[0]), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _sequential(w[:1], x), **TOL)


def test_bubble_fraction():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-12
    for s, m in [(1, 1), (2, 7), (4, 2), (8, 32)]:
        assert bubble_fraction(s, m) == ref_bubble(s, m)
