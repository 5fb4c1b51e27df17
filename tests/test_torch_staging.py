"""The flat layout through which a captured graph's host inputs reach the
card (``core/capture._staging_layout``, ``_leaf_views``): every host leaf at
an offset aligned to ``STAGING_ALIGN`` bytes, none overlapping, a leaf
already on a card left out; packed into one flat byte buffer and read back
through the views, bit for bit."""

import types

import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.core import capture as CP


def _card_stand_in(shape, dtype):
    """A leaf that reads as device memory (``is_cuda``) on the CPU."""
    size = torch.empty(0, dtype=dtype).element_size()
    return types.SimpleNamespace(is_cuda=True, shape=shape, dtype=dtype,
                                 nbytes=int(np.prod(shape)) * size)


def _floats(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    flat = a.reshape(-1)
    flat[:3] = [np.nan, -0.0, np.inf][:flat.size]  # bit patterns a round trip must keep
    return a


CASES = {
    "mixed_dtypes": lambda rng: [_floats(rng, (3, 5)), rng.integers(-9, 9, (7,), dtype=np.int32),
                                 rng.random((2, 3, 4)) < 0.5],
    "zero_size_leaf": lambda rng: [_floats(rng, (4,)), np.zeros((0, 3), np.float32),
                                   rng.integers(0, 99, (5, 2), dtype=np.int32)],
    "cpu_tensor_among_numpy": lambda rng: [rng.random(3) < 0.5,
                                           torch.from_numpy(_floats(rng, (2, 9))),
                                           rng.integers(0, 5, (6,), dtype=np.int32)],
    "card_leaf_left_out": lambda rng: [_floats(rng, (5,)), _card_stand_in((4, 4), torch.float32),
                                       rng.random((65,)) < 0.5, _card_stand_in((3,), torch.int32),
                                       rng.integers(0, 5, (300,), dtype=np.int32)],
}


def _bytes(a) -> bytes:
    return (a.numpy() if torch.is_tensor(a) else np.ascontiguousarray(a)).tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_staging_layout_and_views_round_trip(case):
    leaves = CASES[case](np.random.default_rng(len(case)))
    offsets, nbytes = CP._staging_layout(leaves)
    host = [not CP._on_card(a) for a in leaves]
    assert [off is None for off in offsets] == [not h for h in host]
    placed = [(off, a.nbytes) for off, a in zip(offsets, leaves) if off is not None]
    assert all(off % CP.STAGING_ALIGN == 0 for off, _ in placed)
    for (off, n), (nxt, _) in zip(placed, placed[1:] + [(nbytes, 0)]):
        assert off + n <= nxt  # in order, none overlapping, all inside
    assert nbytes % CP.STAGING_ALIGN == 0

    flat = torch.from_numpy(np.random.default_rng(1).integers(0, 256, nbytes, dtype=np.uint8))
    views = CP._leaf_views(flat, leaves, offsets)
    assert [v is None for v in views] == [not h for h in host]
    for v, a in zip(views, leaves):
        if v is not None:
            v.copy_(CP._as_tensor(a))
    for v, a, off in zip(views, leaves, offsets):
        if v is None:
            continue
        assert v.dtype == CP._leaf_dtype(a) and tuple(v.shape) == tuple(a.shape)
        assert a.nbytes == 0 or v.data_ptr() == flat.data_ptr() + off  # empty: null
        assert _bytes(v) == _bytes(a)
        assert flat[off:off + a.nbytes].numpy().tobytes() == _bytes(a)
