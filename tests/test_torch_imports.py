"""The port stands alone: importing ``repro_torch`` brings in neither JAX
nor the JAX package, its sources name neither, and its entry points run on
the card unless asked for the CPU (``device=None`` without a card raises)."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.mapreduce as port_mr
from repro_torch.core import plan_a2a
from repro_torch.mapreduce.allpairs import _block_fn
from repro_torch.serve import PairwiseService

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        parts = p.relative_to(SRC).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__"
                            else parts))
    return out


def test_importing_every_module_leaves_jax_and_repro_out():
    mods = _modules()
    assert "repro_torch.kernels.pairwise.fused_gather_gram" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(SRC),
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_sources_name_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"(?!_)|from\s+repro(\.|\s)|import\s+repro\.)",
                     re.MULTILINE)
    files = sorted(PKG.rglob("*.py"))
    assert files
    hits = [f"{p}: {m.group(0).strip()}" for p in files
            for m in pat.finditer(p.read_text())]
    assert not hits, hits


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _table():
    return np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)


W = np.full(6, 0.2)


def test_pairwise_similarity_needs_a_card_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mr.pairwise_similarity(_table(), q=1.0, weights=W)


def test_service_needs_a_card_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PairwiseService(q=1.0, executor="fused")


@pytest.mark.parametrize("runner", ["run_reducers", "run_reducers_bucketed"])
def test_runners_need_a_card_by_default(no_cuda, runner):
    plan = port_mr.build_plan(plan_a2a(W, 1.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port_mr, runner)(_table(), plan, _block_fn("dot", False))


@pytest.mark.parametrize("executor", ["dense", "bucketed", "fused"])
def test_executors_need_a_card_by_default(no_cuda, executor):
    plan = port_mr.build_plan(plan_a2a(W, 1.0))
    ex = port_mr.make_executor(executor)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.run(_table(), plan, _block_fn("dot", False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.run_pairs(_table(), plan, _block_fn("dot", False), 6)
