"""Bit-compatible re-implementation of Rust rand's seeded StdRng path.

The reference indexer replaces ambiguous IUPAC bases using
`StdRng::seed_from_u64(--seed)` + `slice::choose` (indexing.rs:29-35,79-93).
The replaced bases are baked into the index and observable through alignment
scores, so index parity requires reproducing the exact choices:

  - rand_core 0.9 `seed_from_u64`: PCG32 stream expands the u64 seed into the
    32-byte ChaCha key.
  - StdRng = ChaCha12Rng (djb variant, 64-bit counter, zero nonce), blocks
    output sequentially.
  - `choose` on a slice = `random_range(0..len)`; for lengths <= u32::MAX
    rand 0.9's UniformUsize samples a u32 and applies Lemire-style widening
    multiply with `zone = range.wrapping_neg() % range` rejection.

Validated against the reference's integration goldens: seed 1234 replaces the
test genome's single 'N' with 'A' (the only value consistent with the
expected MAPQ 37 on the N-site reads, tests/integration_tests.rs:697-762).
"""

from __future__ import annotations

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


def _seed_from_u64(seed: int, nbytes: int = 32) -> bytes:
    mul = 6364136223846793005
    inc = 11634580027462260723
    state = seed & M64
    out = bytearray()
    while len(out) < nbytes:
        state = (state * mul + inc) & M64
        xorshifted = (((state >> 18) ^ state) >> 27) & M32
        rot = (state >> 59) & 31
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & M32
        out += x.to_bytes(4, "little")
    return bytes(out[:nbytes])


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & M32


def _chacha_block(key_words, counter: int, rounds: int = 12):
    consts = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
    state = consts + key_words + [counter & M32, (counter >> 32) & M32, 0, 0]
    x = state[:]

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & M32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & M32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & M32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & M32
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(x[i] + state[i]) & M32 for i in range(16)]


class StdRngCompat:
    """Seeded StdRng (ChaCha12) with rand-0.9-compatible `choose`."""

    def __init__(self, seed: int):
        key_bytes = _seed_from_u64(seed)
        self._key = [
            int.from_bytes(key_bytes[i * 4 : (i + 1) * 4], "little") for i in range(8)
        ]
        self._counter = 0
        self._buf: list[int] = []

    def next_u32(self) -> int:
        if not self._buf:
            self._buf = _chacha_block(self._key, self._counter)
            self._counter += 1
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def choose_index(self, length: int) -> int:
        """random_range(0..length) via u32 widening multiply + rejection."""
        assert 0 < length <= M32
        rng_range = length
        zone = ((1 << 32) - rng_range) % rng_range if rng_range else 0
        while True:
            v = self.next_u32()
            prod = v * rng_range
            hi, lo = prod >> 32, prod & M32
            if lo >= zone:
                return hi

    def choose(self, seq):
        return seq[self.choose_index(len(seq))]
