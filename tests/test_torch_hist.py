"""The port's histogram update (bear_tpu_torch/counting/window_hist.py)
against bear_tpu's Pallas kernel ``sorted_window_update`` (interpret mode)
and ``np.add.at``, on every key pattern of tests/test_pallas_hist.py.

Here, on the CPU, ``window_update`` runs the plain PyTorch version; the
CUDA kernel is held against it on the card (tests/test_torch_cuda.py and
chip_smoke.py). Integer results must match exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bear_tpu.counting import pallas_hist as ph
from bear_tpu_torch.counting import window_hist as wh

torch.set_num_threads(2)
W = ph.WINDOW


@pytest.fixture
def interpret():
    old = ph.INTERPRET
    ph.INTERPRET = True
    yield
    ph.INTERPRET = old


def _dup_boundary_sentinel(rng):
    total = 3 * W - 1234  # non-window-aligned logical size
    padded = ph.padded_size(total)
    idx = rng.integers(0, total, size=5000).astype(np.int32)
    idx[:100] = idx[0]          # heavy duplication
    idx[100:110] = W            # window-boundary keys
    idx[110:120] = W - 1
    masked = rng.random(5000) < 0.1
    keys = np.where(masked, padded, idx).astype(np.int32)
    return np.zeros(padded, np.int32), keys, {}


def _accumulate(rng):
    padded = ph.padded_size(2 * W)
    base = rng.integers(0, 5, size=padded).astype(np.int32)
    return base, rng.integers(0, padded, size=1000).astype(np.int32), {}


def _all_sentinel(rng):
    padded = ph.padded_size(W)
    return np.zeros(padded, np.int32), np.full(512, padded, np.int32), {}


def _negative(rng):
    padded = ph.padded_size(W)
    keys = np.concatenate([np.arange(6, dtype=np.int32),
                           np.full(1000, -1, np.int32)])
    return np.zeros(padded, np.int32), keys, {}


def _touched(n_touched):
    def make(rng):
        padded = 8 * W
        touched = rng.choice(8, size=n_touched, replace=False)
        parts = [rng.integers(w * W, (w + 1) * W, size=rng.integers(1, 400))
                 .astype(np.int32) for w in touched]
        parts.append(np.full(64, padded, np.int32))
        base = rng.integers(0, 3, size=padded).astype(np.int32)
        return base, np.concatenate(parts), {}
    return make


def _blocks(blocks):
    def make(rng):
        padded = 8 * W
        keys = np.concatenate([
            rng.integers(0, padded, size=3000).astype(np.int32),
            np.arange(W - 4, W + 4, dtype=np.int32),
            np.full(64, padded, np.int32),
            np.full(50, -3, np.int32),
        ])
        base = rng.integers(0, 3, size=padded).astype(np.int32)
        return base, keys, {"blocks": blocks}
    return make


def _blocks_degrade(rng):
    # 2-window table with blocks=8: the Pallas grid degrades to 2 blocks.
    keys = np.arange(100, dtype=np.int32) * 577
    return np.zeros(2 * W, np.int32), keys, {"blocks": 8}


def _empty(rng):
    base = rng.integers(0, 3, size=ph.padded_size(W)).astype(np.int32)
    return base, np.zeros(0, np.int32), {}


def _touched_full_stream(rng):
    base, keys, _ = _touched(2)(rng)
    return base, keys, {"skip_empty": False}


def _garbage_beyond_sentinel(rng):
    padded = 24 * W
    keys = np.concatenate([
        rng.integers(0, padded, size=5000).astype(np.int32),
        rng.integers(0, 3 * W, size=4000).astype(np.int32),
        np.full(64, padded, np.int32),
        np.full(50, -9, np.int32),
        np.full(30, padded + 12345, np.int32),
    ])
    base = rng.integers(0, 3, size=padded).astype(np.int32)
    return base, keys, {}


def _small_window(rng):
    total = ph.padded_size(5 * 4**6)
    keys = rng.integers(0, 5 * 4**6, size=50_000).astype(np.int32)
    return np.zeros(total, np.int32), keys, {"group": 512, "window": 4096,
                                             "oh_dtype": jnp.int8}


CASES = {
    "dup_boundary_sentinel": _dup_boundary_sentinel,
    "accumulate": _accumulate,
    "all_sentinel": _all_sentinel,
    "empty": _empty,
    "negative": _negative,
    **{f"touched_{n}": _touched(n) for n in (0, 1, 2, 7)},
    "touched_2_full_stream": _touched_full_stream,
    **{f"blocks_{b}": _blocks(b) for b in (1, 2, 4, 8)},
    "blocks_degrade": _blocks_degrade,
    "garbage_beyond_sentinel": _garbage_beyond_sentinel,
    "small_window_int8": _small_window,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_and_add_at(interpret, case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    base, keys, kw = CASES[case](rng)
    oracle = base.astype(np.int64)
    np.add.at(oracle, keys[(keys >= 0) & (keys < base.size)], 1)

    kw = {"group": 256, **kw}
    jax_out = np.asarray(ph.sorted_window_update(
        jnp.asarray(base), jnp.asarray(keys), **kw))
    table = torch.from_numpy(base.copy())
    out = wh.window_update(table, torch.from_numpy(keys))

    assert out is table  # updated in place
    np.testing.assert_array_equal(table.numpy(), oracle)
    np.testing.assert_array_equal(table.numpy(), jax_out)


def test_cpu_path_launches_no_kernel():
    before = wh.window_update.launches
    wh.window_update(torch.zeros(8, dtype=torch.int32),
                     torch.tensor([1, 1, 7, 8, -1], dtype=torch.int32))
    assert wh.window_update.launches == before


@pytest.mark.parametrize("bad", ["table_int64", "keys_int64", "strided",
                                 "two_d", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table = torch.zeros(16, dtype=torch.int32)
    keys = torch.arange(8, dtype=torch.int32)
    if bad == "table_int64":
        table = table.long()
    elif bad == "keys_int64":
        keys = keys.long()
    elif bad == "strided":
        keys = torch.arange(16, dtype=torch.int32)[::2]
    elif bad == "two_d":
        table = table.reshape(4, 4)
    else:
        table = torch.zeros(16, dtype=torch.int32, device="meta")
        keys = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises((TypeError, ValueError)):
        wh.window_update(table, keys)
