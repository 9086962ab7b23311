"""Philox4x32-10, the counter-based generator of the port's kernels.

The same function is written twice: here in torch (for the kernels' plain
versions and the tests) and in `csrc/philox.cuh` (inside the CUDA kernels).
Both give identical 32-bit words for the same counter and key.

Stream layout, shared by every kernel and its plain version:

* key     = (seed, global chain id): a chain's stream does not depend on the
  batch it is run in or on its position in that batch;
* counter = (word index, move, draw id, 0), with draw ids
  DRAW_RACE = 0 (race: word w covers sites 4w..4w+3), DRAW_ACCEPT = 1 (rrr
  acceptance), DRAW_SKIP = 2 (bkl geometric skip) and DRAW_SITE = 0 (site
  Metropolis acceptance). Single draws use word 0 of counter (0, move, id, 0);
* the checkerboard sweep (DRAW_SWEEP = 3) numbers its colour steps
  t = 2 * sweep + colour in place of the move, sweeps counted across launches
  (`sweep0`). On an even-L lattice the sites 2k and 2k + 1 differ in colour,
  so k = i // 2 is distinct within one colour class: site i takes word
  k % 4 of counter (k // 4, t, DRAW_SWEEP, 0), and no word is spent on the
  other colour;
* the dense sweep (DRAW_SK = 4) numbers its window steps
  t = sweep * n_win + w, windows of WINDOW = 128 consecutive sites and
  n_win = ceil(N / 128), sweeps counted across launches: row r of a window
  (site w * 128 + r) takes word r % 4 of counter (r // 4, t, DRAW_SK, 0);
* tau-EO moves are counted across launches (`move0`): the rank draw
  (DRAW_EO_RANK = 5) is word 0 of counter (0, move, DRAW_EO_RANK, 0), and
  the tie race (DRAW_EO_TIE = 6) gives site i word i % 4 of counter
  (i // 4, move, DRAW_EO_TIE, 0), the layout of the race;
* the replica composites' sweep (DRAW_REPLICA_SWEEP = 7) gives spin j of
  sweep t word j % 4 of counter (j // 4, t, DRAW_REPLICA_SWEEP, 0), the
  race's layout with the sweep in place of the move, sweeps counted across
  launches. The composites' race moves use the race's draws;
* BKL by energy classes (DRAW_CLASS = 8) takes word 0 (the class) and word
  1 (the site within it) of counter (0, move, DRAW_CLASS, 0), and its skip
  from DRAW_SKIP as the race does.

Torch arithmetic: words are int64 tensors holding values in [0, 2^32). The
product of two such values wraps int64, but `(p >> 32) & 0xFFFFFFFF` still
gives the right high word of the unsigned 64-bit product.
"""

from __future__ import annotations

import torch

DRAW_RACE = 0
DRAW_ACCEPT = 1
DRAW_SKIP = 2
DRAW_SITE = 0
DRAW_SWEEP = 3
DRAW_SK = 4
DRAW_EO_RANK = 5
DRAW_EO_TIE = 6
DRAW_REPLICA_SWEEP = 7
DRAW_CLASS = 8

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK = 0xFFFFFFFF


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., Random123). `counter` is 4 and `key` 2
    broadcastable int64 tensors (or ints) holding uint32 values; returns the
    4 output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for _ in range(10):
        p0 = c0 * _M0
        p1 = c2 * _M1
        hi0, lo0 = (p0 >> 32) & _MASK, p0 & _MASK
        hi1, lo1 = (p1 >> 32) & _MASK, p1 & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def as_int32(w: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def chain_keys(seed: int, chain0: int, B: int, device) -> tuple:
    """Philox keys (seed, chain0 + b) for the chains b < B of a batch."""
    ids = torch.arange(B, dtype=torch.int64, device=device) + chain0
    return (torch.tensor(seed & _MASK, dtype=torch.int64, device=device),
            ids & _MASK)


def _moves(move0: int, n: int, device) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.int64, device=device) + move0) & _MASK


def draw_bits(seed: int, chain0: int, B: int, move0: int, n: int, draw: int,
              device) -> torch.Tensor:
    """[n, B] int32: word 0 of counter (0, move, draw, 0) for the moves
    move0 .. move0 + n - 1 of each chain."""
    k0, k1 = chain_keys(seed, chain0, B, device)
    mv = _moves(move0, n, device)[:, None]
    return as_int32(philox4x32_10((0, mv, draw, 0), (k0, k1))[0])


def class_bits(seed: int, chain0: int, B: int, move0: int, n: int,
               device) -> torch.Tensor:
    """[n, B, 2] int32: words 0 and 1 of counter (0, move, DRAW_CLASS, 0)
    for the moves move0 .. move0 + n - 1 of each chain."""
    k0, k1 = chain_keys(seed, chain0, B, device)
    mv = _moves(move0, n, device)[:, None]
    w = philox4x32_10((0, mv, DRAW_CLASS, 0), (k0, k1))
    return as_int32(torch.stack(w[:2], dim=-1))


def race_bits(seed: int, chain0: int, B: int, N: int, move0: int, n: int,
              device, draw: int = DRAW_RACE) -> torch.Tensor:
    """[n, B, N] int32 race bits of the moves move0 .. move0 + n - 1: site
    i takes word i % 4 of counter (i // 4, move, draw, 0)."""
    k0, k1 = chain_keys(seed, chain0, B, device)
    W = -(-N // 4)
    widx = torch.arange(W, dtype=torch.int64, device=device)
    mv = _moves(move0, n, device)[:, None, None]
    ws = philox4x32_10((widx, mv, draw, 0), (k0, k1[:, None]))
    return as_int32(torch.stack(ws, dim=-1).reshape(n, B, 4 * W)[..., :N])


def eo_rank_bits(seed: int, chain0: int, B: int, move0: int, n: int,
                 device) -> torch.Tensor:
    """[n, B] int32 rank draws of the EO moves move0 .. move0 + n - 1."""
    return draw_bits(seed, chain0, B, move0, n, DRAW_EO_RANK, device)


def eo_tie_bits(seed: int, chain0: int, B: int, N: int, move0: int, n: int,
                device) -> torch.Tensor:
    """[n, B, N] int32 tie-race bits of the EO moves move0 ..
    move0 + n - 1: site i takes word i % 4 of counter (i // 4, move,
    DRAW_EO_TIE, 0)."""
    return race_bits(seed, chain0, B, N, move0, n, device, draw=DRAW_EO_TIE)


def sweep_bits(seed: int, chain0: int, B: int, N: int, sweep: int,
               colour: int, device) -> torch.Tensor:
    """[B, N] int32 bits of one checkerboard colour step: site i takes word
    (i // 2) % 4 of counter ((i // 2) // 4, 2 * sweep + colour, DRAW_SWEEP,
    0) (only the sites of that colour use theirs)."""
    k0, k1 = chain_keys(seed, chain0, B, device)
    W = -(-N // 8)
    widx = torch.arange(W, dtype=torch.int64, device=device)
    t = (2 * sweep + colour) & _MASK
    ws = philox4x32_10((widx, t, DRAW_SWEEP, 0), (k0, k1[:, None]))
    words = torch.stack(ws, dim=-1).reshape(B, 4 * W)
    return as_int32(words.repeat_interleave(2, dim=1)[:, :N])


def sk_bits(seed: int, chain0: int, B: int, W: int, t: int,
            device) -> torch.Tensor:
    """[B, W] int32 bits of one dense-sweep window step t: row r takes word
    r % 4 of counter (r // 4, t, DRAW_SK, 0)."""
    k0, k1 = chain_keys(seed, chain0, B, device)
    G = -(-W // 4)
    widx = torch.arange(G, dtype=torch.int64, device=device)
    ws = philox4x32_10((widx, t & _MASK, DRAW_SK, 0), (k0, k1[:, None]))
    return as_int32(torch.stack(ws, dim=-1).reshape(B, 4 * G)[:, :W])


def per_move(make, n_moves: int, block: int):
    """Iterate over moves 0 .. n_moves - 1, yielding make(lo, n)[m - lo]:
    the bits of one move, drawn `block` moves at a time."""
    for lo in range(0, n_moves, block):
        n = min(block, n_moves - lo)
        yield from make(lo, n)


def to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> float32 u = bits * 2^-32 + 1/2, in [0, 1] (the JAX
    kernels' mapping; f32 rounding can give exactly 0 or 1)."""
    return bits.to(torch.float32) * (2.0 ** -32) + 0.5
