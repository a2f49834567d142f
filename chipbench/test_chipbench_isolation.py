"""A run loads neither JAX nor the JAX package (top-level names compared
whole), nor the repository's other tools; the reference loads nothing of
the port; without a card the command prints no result."""

import json
import subprocess
import sys

from chipbench import spec

NOT_LOADED = {"jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks",
              "tools"}


def _python(code: str, *args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code, *args],
                          cwd=spec.ROOT, capture_output=True, text=True,
                          timeout=240)


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import json, sys\n"
        "sys.path[:0] = ['src', '.']\n"
        "from chipbench import cell, control, faults, run\n"
        "from chipbench._small import small_spec\n"
        "rec = cell.run(small_spec(), 5, 0.2, True, device_type='cpu')\n"
        "print(json.dumps([sorted({n.split('.')[0] for n in sys.modules}),"
        " rec['banned']]))\n")
    p = _python(code)
    assert p.returncode == 0, p.stderr
    loaded, banned = json.loads(p.stdout.strip().splitlines()[-1])
    assert "repro_torch" in loaded
    assert not NOT_LOADED & set(loaded)
    assert banned == []


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import torch\n"
            "from chipbench import reference, roofline, sizes, trace\n"
            "reference.cosine_a2a(torch.randn(8, 4))\n"
            "print(sorted(n for n in sys.modules"
            " if n.split('.')[0] in ('repro_torch', 'repro', 'jax')))\n")
    p = _python(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_without_a_card_the_command_prints_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "chipbench.run", "--workload",
         "a2a-nytimes.refresh", "--seed", str(2 ** 33 + 1), "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=240, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert p.returncode != 0
    assert p.stdout == ""
