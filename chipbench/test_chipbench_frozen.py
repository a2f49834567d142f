"""The harness's frozen copies equal the port's current functions: the
size draw of ``chip_smoke.py`` and the work model and peaks of
``repro_torch.launch.roofline``, on small plans."""

import json
import sys

import numpy as np
import pytest

from chipbench import roofline, spec
from chipbench.sizes import draw_sizes


def _config(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(spec.ROOT))
    import chip_smoke as cs
    return cs


CONFIG = "a2a-nytimes-m8192-d256"


@pytest.mark.parametrize("m", [64, 4096, 8192])
def test_zipf_sizes_equal_chip_smoke(chip_smoke, m):
    c = _config(CONFIG)
    c["sizes"][0]["n"] = m
    (w,) = draw_sizes(c["sizes"], c["profile_seed"])
    np.testing.assert_array_equal(w, chip_smoke.bench_profile(m, 8, 0)[0])


def test_peaks_equal_the_ports():
    from repro_torch.launch import roofline as port
    p = roofline.PEAKS[port.H100_SXM.name]
    assert p == {"fp32_flops": port.H100_SXM.peak_fp32_flops,
                 "hbm_bytes": port.H100_SXM.hbm_bw}
    work = {"ops": 6.7e9, "bytes": 1e6}
    assert roofline.bound(work, p["fp32_flops"], p["hbm_bytes"]) * 1e3 == \
        pytest.approx(port.bound(work, p["fp32_flops"], p["hbm_bytes"])[0])


def test_square_work_equals_the_ports():
    from repro_torch.core import plan_a2a
    from repro_torch.launch import roofline as port
    from repro_torch.mapreduce.engine import build_plan
    (w,) = draw_sizes(_config(CONFIG)["sizes"][:1], 3)
    plan = build_plan(plan_a2a(w[:300], 1.0))
    assert len(plan.buckets) > 1
    for b in plan.buckets:
        assert roofline.bucket_work(b, 64) == port.bucket_work(b, 64)
    assert roofline.work_model(plan, 300, 64, 4) == \
        port.work_model(plan, 300, 64, 4)
