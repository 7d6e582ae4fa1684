"""The port's TrainingDataset and host input pipeline against the JAX
package's on the same json/h5 fixtures and seeds: items and batches must be
identical bit for bit."""
import json
import os

import h5py
import numpy as np
import pytest

from dt4image_restoration_tpu.config import (OPTIMAL_RTG_RANGE,
                                             OPTIMAL_TASKS)
from dt4image_restoration_tpu.data import TrainingDataset as JDataset
from dt4image_restoration_tpu.data.datasets import (
    extract_task as j_extract_task, minmax_normalize as j_minmax)
from dt4image_restoration_tpu_torch.data import (BATCH_KEYS,
                                                 TrainingDataset,
                                                 extract_task,
                                                 gather_scale_u8,
                                                 minmax_normalize)
from dt4image_restoration_tpu_torch.training import background_batches

LENGTHS = (4, 6, 9, 11, 3)   # shorter than, equal to and longer than 6
SIDE = 36


@pytest.fixture
def traj_dir(tmp_path):
    """Trajectory jsons and an h5 of uint8 states in the reference layout:
    state paths whose first 10 characters are stripped to form the h5
    key."""
    rng = np.random.default_rng(7)
    h5_path = tmp_path / "states.h5"
    data_dir = tmp_path / "trajs"
    os.makedirs(data_dir)
    with h5py.File(h5_path, "w") as f:
        for i, length in enumerate(LENGTHS):
            paths = []
            for t in range(length):
                key = f"traj{i}/state{t}"
                f.create_dataset(key, data=rng.integers(
                    0, 256, (SIDE, SIDE)).astype(np.uint8))
                paths.append("0123456789" + key)
            traj = {
                "RTG": list(np.linspace(5 + i, -1, length)),
                "Actions": {k: list(rng.uniform(0, 1, length))
                            for k in ("mu", "T", "sigma_d")},
                "State Paths": paths,
                "Task": OPTIMAL_TASKS[i % len(OPTIMAL_TASKS)],
            }
            with open(data_dir / f"traj_{i}.json", "w") as jf:
                json.dump(traj, jf)
    return str(data_dir), str(h5_path)


def _pair(traj_dir, preload=False, normalize=True, seed=3):
    data_dir, h5_path = traj_dir
    lo, hi = OPTIMAL_RTG_RANGE
    kw = dict(block_size=6, data_dir=data_dir, action_dim=3,
              state_file_path=h5_path, tasks=OPTIMAL_TASKS, min_rtg=lo,
              max_rtg=hi, image_size=SIDE, normalize_rtg=normalize)
    port = TrainingDataset(rng=np.random.default_rng(seed), preload=preload,
                           **kw)
    ref = JDataset(rng=np.random.default_rng(seed), **kw)
    return port, ref


def _same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("preload", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_items_bit_identical_to_jax(traj_dir, preload, normalize):
    port, ref = _pair(traj_dir, preload=preload, normalize=normalize)
    # Twice over: the window crops draw from the rng in the same order.
    for _ in range(2):
        for i in range(len(LENGTHS)):
            for got, want in zip(port[i], ref[i]):
                _same(got, want)


@pytest.mark.parametrize("preload", [False, True])
@pytest.mark.parametrize("shuffle,drop_remainder,batch_size,num_shards", [
    (True, True, 2, 1),
    (False, True, 2, 1),
    (True, False, 2, 1),
    (True, True, 1, 3),     # 5 trajectories on 3 shards: wrap-padded
    (True, False, 2, 2),    # 3 a shard: a short last batch
    (True, True, 1, 8),     # a pad longer than the dataset
])
def test_batches_bit_identical_to_jax(traj_dir, preload, shuffle,
                                      drop_remainder, batch_size,
                                      num_shards):
    port, ref = _pair(traj_dir, preload=preload)
    counts = set()
    for shard in range(num_shards):
        kw = dict(batch_size=batch_size, shuffle=shuffle,
                  drop_remainder=drop_remainder, seed=11,
                  shard_index=shard, num_shards=num_shards)
        got, want = list(port.batches(**kw)), list(ref.batches(**kw))
        assert len(got) == len(want) > 0
        counts.add(len(got))
        for g, w in zip(got, want):
            assert tuple(g) == BATCH_KEYS == tuple(w)
            for k in BATCH_KEYS:
                _same(g[k], w[k])
    assert len(counts) == 1   # every shard yields as many batches


def test_preload_matches_streaming_and_copies(traj_dir):
    streaming, _ = _pair(traj_dir)
    preloaded, _ = _pair(traj_dir, preload=True)
    for a, b in zip(streaming.batches(2, seed=5),
                    preloaded.batches(2, seed=5)):
        for k in BATCH_KEYS:
            _same(b[k], a[k])
    item = preloaded[3]
    item[1][:] = -1.0                       # actions handed out are copies
    assert (preloaded[3][1] >= 0).all()


def test_gather_scale_u8():
    src = np.arange(256, dtype=np.uint8).reshape(2, 128)
    out = gather_scale_u8(src, np.asarray([[1, -1], [0, 1]]))
    assert out.shape == (2, 2, 128) and out.dtype == np.float32
    _same(out[0, 0], np.float32(src[1] / 255))
    _same(out[0, 1], np.zeros(128, np.float32))
    _same(out[1, 0], np.float32(src[0] / 255))
    with pytest.raises(IndexError):
        gather_scale_u8(src, np.asarray([2]))


def test_task_and_rtg_helpers_match_jax():
    for name in ("img_4_15_slice0.mat", "8_5.mat", "a2_10b"):
        assert extract_task(name) == j_extract_task(name)
    with pytest.raises(ValueError):
        extract_task("nopattern.mat")
    vals = np.linspace(-3, 20, 17)
    _same(minmax_normalize(vals, *OPTIMAL_RTG_RANGE),
          j_minmax(vals, *OPTIMAL_RTG_RANGE))


def test_background_batches_reraises_iterator_errors():
    def bad():
        yield {"ok": np.zeros(1)}
        raise ValueError("corrupt trajectory file")

    it = background_batches(bad())
    assert next(it)["ok"].shape == (1,)
    with pytest.raises(ValueError, match="corrupt trajectory"):
        next(it)


def test_background_batches_keeps_order_and_ends():
    got = list(background_batches(iter(range(50)), size=3))
    assert got == list(range(50))
