"""Philox4x32-10 of the port (rrrmc_tpu_torch/ops/prng.py): known-answer
vectors, the stream layout the CUDA kernels share, and independence of a
chain's stream from the batch it runs in."""

import pytest
import torch

from rrrmc_tpu_torch.ops import prng

torch.set_num_threads(1)

#: Random123's known-answer vectors: (counter; key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_known_answers(ctr, key, want):
    got = prng.philox4x32_10(ctr, key)
    assert tuple(int(w) for w in got) == want


def test_known_answers_batched():
    """The tensor path (broadcast counters and keys) gives the same words."""
    ctr = [torch.tensor([c[i] for c, _, _ in KAT]) for i in range(4)]
    key = [torch.tensor([k[i] for _, k, _ in KAT]) for i in range(2)]
    got = torch.stack(prng.philox4x32_10(ctr, key), dim=1).tolist()
    assert [tuple(r) for r in got] == [w for _, _, w in KAT]


def _word(seed, chain, ctr, j):
    w = int(prng.philox4x32_10(ctr, (seed, chain))[j])
    return w - 2 ** 32 if w >= 2 ** 31 else w


def test_stream_layout():
    """race_bits[m, b, i] is word i % 4 of counter (i // 4, move0 + m,
    DRAW_RACE, 0) under key (seed, chain0 + b); draw_bits[m, b] word 0 of
    (0, move0 + m, draw, 0) -- the layout csrc/philox.cuh reads."""
    seed, chain0, B, N, move0 = 12345, 7, 3, 10, 1000
    race = prng.race_bits(seed, chain0, B, N, move0, 2, "cpu")
    assert race.shape == (2, B, N) and race.dtype == torch.int32
    for m, b, i in [(0, 0, 0), (1, 2, 9), (0, 1, 5), (1, 0, 3)]:
        want = _word(seed, chain0 + b, (i // 4, move0 + m, prng.DRAW_RACE, 0),
                     i % 4)
        assert int(race[m, b, i]) == want
    for d in (prng.DRAW_ACCEPT, prng.DRAW_SKIP):
        acc = prng.draw_bits(seed, chain0, B, move0, 2, d, "cpu")
        assert acc.shape == (2, B)
        assert int(acc[1, 2]) == _word(seed, chain0 + 2, (0, move0 + 1, d, 0),
                                       0)


def test_sweep_stream_layout():
    """sweep_bits[b, i] of colour step (sweep, colour) is word (i // 2) % 4
    of counter ((i // 2) // 4, 2 * sweep + colour, DRAW_SWEEP, 0): the two
    sites of a pair share a word, so one colour class uses each word
    once."""
    seed, chain0, B, N, sw = 77, 3, 2, 36, 1234
    for colour in (0, 1):
        bits = prng.sweep_bits(seed, chain0, B, N, sw, colour, "cpu")
        assert bits.shape == (B, N) and bits.dtype == torch.int32
        for b, i in [(0, 0), (1, 7), (0, 17), (1, 35)]:
            k = i // 2
            want = _word(seed, chain0 + b,
                         (k // 4, 2 * sw + colour, prng.DRAW_SWEEP, 0), k % 4)
            assert int(bits[b, i]) == want
        assert torch.equal(bits[:, 0::2], bits[:, 1::2])
    assert prng.DRAW_SWEEP not in (prng.DRAW_RACE, prng.DRAW_ACCEPT,
                                   prng.DRAW_SKIP)


def test_streams_independent_of_batch_layout():
    whole = prng.race_bits(9, 0, 8, 13, 5, 3, "cpu")
    part = prng.race_bits(9, 4, 4, 13, 5, 3, "cpu")
    assert torch.equal(whole[:, 4:], part)
    assert torch.equal(prng.draw_bits(9, 0, 8, 5, 3, 1, "cpu")[:, 4:],
                       prng.draw_bits(9, 4, 4, 5, 3, 1, "cpu"))


def test_per_move_blocks():
    make = lambda lo, n: prng.draw_bits(3, 0, 4, lo, n, 0, "cpu")  # noqa
    blocked = torch.stack(list(prng.per_move(make, 10, 3)))
    assert torch.equal(blocked, make(0, 10))


def test_to_uniform_range():
    bits = torch.tensor([-2 ** 31, 0, 2 ** 31 - 1], dtype=torch.int32)
    u = prng.to_uniform(bits)
    assert u.dtype == torch.float32
    assert u.tolist() == [0.0, 0.5, 1.0]
