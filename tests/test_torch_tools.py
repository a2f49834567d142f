"""The card scripts (``chip_smoke.py``, ``tools/kernel_ab.py``) on the CPU:
they import neither JAX nor the JAX package, every kernel variant of the
A/B script is an edit that still applies to the committed sources, and its
emulated 3-product bf16 split of the fp32 SSD products tracks the plain
chunked scan."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd.ref import ssd_scan_chunked

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py"))]


def _kernel_ab():
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", ROOT / "tools" / "kernel_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_card_scripts_name_neither_jax_nor_repro(path):
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"(?!_)|from\s+repro(\.|\s)|import\s+repro\.)",
                     re.MULTILINE)
    assert not pat.findall(path.read_text())


def test_every_variant_edits_the_committed_sources():
    ab = _kernel_ab()
    committed = {p.name: p.read_text() for p in ab.CSRC.glob("*.cu*")}
    for name, (lib, edited, _) in ab.VARIANTS.items():
        out = ab.edited_sources(name)
        assert f"{lib}.cu" in out and set(out) == set(committed)
        assert all(out[f] == committed[f] for f in out if f != edited)


def test_variant_edit_that_misses_raises(monkeypatch):
    ab = _kernel_ab()
    monkeypatch.setitem(ab.VARIANTS, "bogus", (
        "ssd_scan", "ssd_scan.cu", [(r"constexpr int NO_SUCH = 1;", "")]))
    with pytest.raises(RuntimeError, match="matched 0 times"):
        ab.edited_sources("bogus")


@pytest.mark.parametrize("S,chunk", [(40, 16), (100, 32)])
def test_split3_emulation_tracks_the_plain_scan(S, chunk):
    """hi.hi + hi.lo + lo.hi keeps ~16 bits of every fp32 product, so the
    emulated scan agrees with the fp32 one far inside its 2e-4 contract on
    small inputs, ten times closer than one bf16 rounding of the inputs."""
    ab = _kernel_ab()
    rng = np.random.default_rng(S)
    H, P, N = 3, 8, 16
    x = torch.from_numpy(rng.normal(size=(H, S, P)).astype(np.float32))
    b, c = (torch.from_numpy(rng.normal(size=(H, S, N)).astype(np.float32))
            * N ** -0.5 for _ in range(2))
    la = -torch.from_numpy(np.abs(rng.normal(size=(H, S))).astype(
        np.float32)) * 0.1
    want = ssd_scan_chunked(x, la, b, c, chunk=chunk)
    got = ab.chunked_split3(x, la, b, c, chunk)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    r = (lambda t: t.bfloat16().float())      # one bf16 rounding
    one = ssd_scan_chunked(r(x), la, r(b), r(c), chunk=chunk)
    assert float((one - want).abs().max()) > 10 * float(
        (got - want).abs().max())


@pytest.mark.parametrize("name", ["rect", "rect_tmin4", "rect_tmax64",
                                  "rect_stages3", "rect_chunk64",
                                  "rect_square_tiles"])
def test_rect_variants_change_one_line(name):
    """The rect part compares the committed kernel (``rect``, no edit) with
    variants that each change one design constant: one line of one
    file."""
    ab = _kernel_ab()
    lib, edited, edits = ab.VARIANTS[name]
    assert lib == "fused_gather_gram_rect"
    committed = (ab.CSRC / edited).read_text().splitlines()
    out = ab.edited_sources(name)[edited].splitlines()
    changed = [a for a, b in zip(committed, out) if a != b]
    assert len(out) == len(committed)
    assert len(changed) == len(edits)
