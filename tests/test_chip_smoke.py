"""chip_smoke.py off the card: it refuses to run without a GPU, and its
comparisons and parsers behave on synthetic data."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("args", [(), ("--cards", "4")])
def test_exits_nonzero_without_gpu(args):
    r = _run(ROOT, *args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_parse_cards():
    assert cs.parse_args([]).cards == 1
    assert cs.parse_args(["--cards", "4"]).cards == 4
    with pytest.raises(SystemExit):
        cs.parse_args(["--cards", "2"])


def _hist(density, rgb=0.5):
    h = np.zeros((len(density) + 1, 4))
    h[:-1, 3] = density
    h[:-1, :3] = rgb
    return h


def test_tv_identical_disjoint_and_scale_free():
    a = _hist([1, 2, 3, 0])
    assert cs.tv(a, a) == 0.0
    assert cs.tv(a, 10 * a) == pytest.approx(0.0)
    assert cs.tv(_hist([1, 0]), _hist([0, 1])) == pytest.approx(1.0)
    # the junk bin never counts
    b = a.copy()
    b[-1, 3] = 1e6
    assert cs.tv(a, b) == 0.0


def test_tv_limit_rule():
    assert cs.tv_limit(0.0) == cs.TV_MIN
    assert cs.tv_limit(0.02) == pytest.approx(0.08)


def test_hist_errors_exact_and_off_by_one():
    rng = np.random.default_rng(0)
    addr = rng.integers(0, 51, 2000)
    rgba = rng.random((2000, 4)).astype(np.float32)
    rgba[:, 3] = 1
    ref = cs.reference_hist(50, addr, rgba)
    assert ref[:, 3].sum() == 2000
    assert cs.hist_errors(ref.astype(np.float32), ref)[0] == 0.0
    bad = ref.copy()
    bad[7, 3] += 1
    assert cs.hist_errors(bad, ref)[0] == 1.0
    bad = ref.copy()
    bad[7, 0] += 1e-3 * max(ref[7, 3], 1)
    assert cs.hist_errors(bad, ref)[1] == pytest.approx(1e-3)
    # the junk bin's rgb is never compared
    bad = ref.copy()
    bad[-1, 0] += 5
    assert cs.hist_errors(bad, ref)[1] == 0.0


def test_u8_delta_and_nonblack_share():
    a = np.zeros((4, 4, 4), np.uint8)
    b = a.copy()
    b[1, 2, 0] = 3
    assert cs.u8_delta(a, b) == 3
    assert cs.nonblack_share(b) == pytest.approx(1 / 16)
    a[..., 3] = 255                       # alpha alone is not light
    assert cs.nonblack_share(a) == 0.0


def test_read_y4m_roundtrip(tmp_path):
    from cuburn_tpu.output import Y4MSink
    path = str(tmp_path / "a.y4m")
    sink = Y4MSink(path, 6, 4, fps=6)
    frames = [np.full((4, 6, 4), 40 * i, np.uint8) for i in range(3)]
    for f in frames:
        sink.write_frame(f)
    sink.close()
    w, h, planes = cs.read_y4m(path)
    assert (w, h, len(planes)) == (6, 4, 3)
    assert planes[0].max() == 0 and planes[2].min() > 0


def test_read_y4m_rejects_truncated(tmp_path):
    path = tmp_path / "t.y4m"
    path.write_bytes(b"YUV4MPEG2 W4 H2 F6:1\nFRAME\n" + b"\0" * 5)
    with pytest.raises(cs.SmokeFailure):
        cs.read_y4m(str(path))


def test_check_raises():
    cs.check(True, "fine")
    with pytest.raises(cs.SmokeFailure, match="broken"):
        cs.check(False, "broken")
