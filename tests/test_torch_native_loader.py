"""The port's native batch gather (data/native_loader.py,
csrc/gather_scale.cpp) against the JAX package's (data/native_loader.py)
and its own numpy twin: bit for bit at 1, 2 and 8 threads with -1 pads;
out-of-range rows raise; a failed build raises with the compiler's output;
``preload=True`` batches equal streaming ones and the JAX package's preload
batches."""
import numpy as np
import pytest

from dt4image_restoration_tpu.config import OPTIMAL_RTG_RANGE, OPTIMAL_TASKS
from dt4image_restoration_tpu.data import TrainingDataset as JDataset
from dt4image_restoration_tpu.data.native_loader import (
    gather_scale_u8 as j_gather_scale_u8)
from dt4image_restoration_tpu_torch.data import BATCH_KEYS
from dt4image_restoration_tpu_torch.data import native_loader
from dt4image_restoration_tpu_torch.data.native_loader import (
    _gather_numpy, default_threads, gather_scale_u8, native_available)
from dt4image_restoration_tpu_torch.ops.kernels import _build
from test_torch_train_data import _pair, traj_dir  # noqa: F401


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.fixture(scope="module")
def src_rows():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (40, 36 * 36)).astype(np.uint8)
    src[0] = np.arange(36 * 36) % 256          # every byte value
    rows = rng.integers(-1, 40, (4, 6, 3))     # -1: pad rows
    rows[0, 0] = -1
    return src, rows


def test_library_builds_under_build(src_rows):
    assert native_available()
    path = _build.library_path("gather_scale")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "kernels")
    assert 1 <= default_threads() <= 8


@pytest.mark.parametrize("n_threads", [1, 2, 8])
def test_gather_is_bit_exact_with_jax_and_numpy(src_rows, n_threads):
    src, rows = src_rows
    got = gather_scale_u8(src, rows, n_threads=n_threads)
    assert got.shape == rows.shape + (src.shape[1],)
    assert got.dtype == np.float32
    twin = _gather_numpy(src, rows.reshape(-1)).reshape(got.shape)
    np.testing.assert_array_equal(_bits(got), _bits(twin))
    np.testing.assert_array_equal(
        _bits(got), _bits(j_gather_scale_u8(src, rows, n_threads)))
    np.testing.assert_array_equal(_bits(got[..., 0, :][rows[..., 0] >= 0]),
                                  _bits(np.float32(
                                      src[rows[..., 0][rows[..., 0] >= 0]]
                                      / 255)))
    assert not got[0, 0].any()


def test_bad_input_raises(src_rows):
    src, _ = src_rows
    with pytest.raises(IndexError, match="out of range"):
        gather_scale_u8(src, np.array([[0, 40]]))
    with pytest.raises(ValueError, match="uint8"):
        gather_scale_u8(src.astype(np.float32), np.array([0]))


def test_disable_switch_runs_the_numpy_twin(src_rows, monkeypatch):
    src, rows = src_rows
    monkeypatch.setenv("DT4IR_NATIVE_DISABLE", "1")
    monkeypatch.setattr(native_loader, "_library", lambda: pytest.fail(
        "the C++ gather ran under DT4IR_NATIVE_DISABLE=1"))
    assert not native_available()
    np.testing.assert_array_equal(
        _bits(gather_scale_u8(src, rows)),
        _bits(_gather_numpy(src, rows.reshape(-1)).reshape(
            rows.shape + (src.shape[1],))))


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    """No quiet fallback: a source that does not compile raises, with
    g++'s message."""
    (tmp_path / "gather_scale.cpp").write_text(
        "extern \"C\" void dt4ir_gather_scale() { not valid c++ }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match=r"gather_scale: g\+\+ exit"):
        native_available()
    with pytest.raises(RuntimeError, match="kernel build failed"):
        gather_scale_u8(np.zeros((2, 4), np.uint8), np.array([0]))


def test_preload_batches_equal_streaming_and_jax_preload(traj_dir):
    data_dir, h5_path = traj_dir
    streaming, _ = _pair(traj_dir)
    preloaded, _ = _pair(traj_dir, preload=True)
    lo, hi = OPTIMAL_RTG_RANGE
    ref = JDataset(block_size=6, data_dir=data_dir, action_dim=3,
                   state_file_path=h5_path, tasks=OPTIMAL_TASKS, min_rtg=lo,
                   max_rtg=hi, image_size=36, rng=np.random.default_rng(3),
                   preload=True)
    n = 0
    for a, b, w in zip(streaming.batches(2, seed=5),
                       preloaded.batches(2, seed=5),
                       ref.batches(2, seed=5)):
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(b[k], a[k])
            np.testing.assert_array_equal(b[k], w[k])
        assert b["states"].dtype == np.float32
        n += 1
    assert n == 2
