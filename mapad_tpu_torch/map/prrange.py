"""Lazy pseudo-random permutation of a range (reference src/map/prrange.rs).

Lehmer LCG modulo the next prime > range length, with a primitive-root
multiplier; used to report a random position for multi-mapping reads without
materializing the suffix-array interval.
"""

from __future__ import annotations


def _is_prime(n: int) -> bool:
    if n <= 1:
        return False
    if n <= 3:
        return True
    if n % 2 == 0 or n % 3 == 0:
        return False
    i = 5
    while i * i <= n:
        if n % i == 0 or n % (i + 2) == 0:
            return False
        i += 6
    return True


def _next_prime(n: int) -> int:
    p = n + 1
    if p <= 2:
        return 2
    if p % 2 == 0:
        p += 1
    while not _is_prime(p):
        p += 2
    return p


def _prime_factors(n: int):
    """Distinct prime factors of n (PrimeFactorIterator semantics)."""
    out = []
    i = 2
    while i * i <= n:
        if n % i == 0:
            out.append(i)
            while n % i == 0:
                n //= i
        i += 1 if i == 2 else 2
    if n > 1:
        out.append(n)
    return out


def _pow_mod(base: int, exponent: int, modulus: int) -> int:
    return pow(base, exponent, modulus)


def _is_primitive_root(a: int, n: int) -> bool:
    phi = n - 1
    for p in _prime_factors(phi):
        if _pow_mod(a, phi // p, n) == 1:
            return False
    return True


class PrRange:
    """Iterator over a pseudo-random permutation of [start, end)."""

    def __init__(self, start: int, l: int, m: int, a: int, seed: int):
        self.start = start
        self.l = l
        self.m = m
        self.a = a
        self.x = seed
        self.seed = seed
        self.count = 0

    @classmethod
    def try_new(cls, start: int, end: int, seed: int):
        l = max(end - start, 0)
        if l == 0:
            return None
        m = _next_prime(l)
        a = 2
        while not _is_primitive_root(a, m):
            a += 1
        seed = max(seed % l, 1)
        return cls(start, l, m, a, seed)

    def __iter__(self):
        return self

    def __next__(self):
        if self.count == 0 and self.l == 1:
            self.count += 1
            return self.start
        while True:
            prev_x = self.x
            self.x = (self.a * self.x) % self.m
            if self.count > 0 and prev_x == self.seed:
                raise StopIteration
            if prev_x <= self.l:
                self.count += 1
                return prev_x - 1 + self.start
