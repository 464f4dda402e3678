"""RngStream: L'Ecuyer's MRG32k3a with streams and substreams.

Capability-equivalent of the reference's vendored RngStream
(src/xbt/RngStream.c, the standard public-domain generator): the same
combined multiple-recursive generator, the same stream spacing (2^127
states apart) and substream spacing (2^76), so independent simulation
components can draw reproducible, non-overlapping random sequences.
Implemented from the published recurrences — not a translation of the
C file.

The port's own copy of ``simgrid_tpu/utils/rngstream.py``: fault
campaigns draw from it, and the draws must be the reference's bits."""

from __future__ import annotations

from typing import List

_M1 = 4294967087.0
_M2 = 4294944443.0
_A12 = 1403580.0
_A13N = 810728.0
_A21 = 527612.0
_A23N = 1370589.0
_NORM = 2.328306549295727688e-10   # 1/(m1+1)
_TWO17 = 131072.0
_TWO53 = 9007199254740992.0

# A1^(2^76) mod m1 / A2^(2^76) mod m2: substream jump matrices;
# A1^(2^127) / A2^(2^127): stream jump matrices (standard constants of
# the generator, derivable by matrix exponentiation below).


def _mat_vec(A, s, m):
    return [sum(A[i][j] * s[j] for j in range(3)) % m for i in range(3)]


def _mat_mat(A, B, m):
    return [[sum(A[i][k] * B[k][j] for k in range(3)) % m
             for j in range(3)] for i in range(3)]


def _mat_pow2(A, e, m):
    """A^(2^e) mod m by repeated squaring (integer arithmetic)."""
    B = [row[:] for row in A]
    for _ in range(e):
        B = _mat_mat(B, B, m)
    return B


_A1 = [[0, 1, 0], [0, 0, 1], [int(-_A13N) % int(_M1), int(_A12), 0]]
_A2 = [[0, 1, 0], [0, 0, 1], [int(-_A23N) % int(_M2), int(_A21), 0]]
_A1_int = [[int(x) for x in row] for row in _A1]
_A2_int = [[int(x) for x in row] for row in _A2]
_A1_SUB = _mat_pow2(_A1_int, 76, int(_M1))
_A2_SUB = _mat_pow2(_A2_int, 76, int(_M2))
_A1_STREAM = _mat_pow2(_A1_int, 127, int(_M1))
_A2_STREAM = _mat_pow2(_A2_int, 127, int(_M2))

_DEFAULT_SEED = [12345] * 6


class RngStream:
    """One stream of the generator; successive constructions advance a
    package-level base seed by 2^127 like RngStream_CreateStream."""

    _next_seed: List[int] = list(_DEFAULT_SEED)

    def __init__(self, name: str = ""):
        self.name = name
        self._ig = list(RngStream._next_seed)   # stream initial state
        self._bg = list(self._ig)               # substream start
        self._cg = list(self._ig)               # current state
        RngStream._next_seed = (
            _mat_vec(_A1_STREAM, RngStream._next_seed[:3], int(_M1))
            + _mat_vec(_A2_STREAM, RngStream._next_seed[3:], int(_M2)))

    # -- seeding -----------------------------------------------------------
    @classmethod
    def set_package_seed(cls, seed: List[int]) -> None:
        assert len(seed) == 6
        cls._next_seed = list(int(s) for s in seed)

    def set_seed(self, seed: List[int]) -> None:
        assert len(seed) == 6
        self._ig = [int(s) for s in seed]
        self._bg = list(self._ig)
        self._cg = list(self._ig)

    # -- stream navigation (RngStream.c Reset*/Advance) -------------------
    def reset_start_stream(self) -> None:
        self._bg = list(self._ig)
        self._cg = list(self._ig)

    def reset_start_substream(self) -> None:
        self._cg = list(self._bg)

    def reset_next_substream(self) -> None:
        self._bg = (_mat_vec(_A1_SUB, self._bg[:3], int(_M1))
                    + _mat_vec(_A2_SUB, self._bg[3:], int(_M2)))
        self._cg = list(self._bg)

    # -- draws (RngStream.c U01) ------------------------------------------
    def rand_u01(self) -> float:
        s = self._cg
        p1 = (_A12 * s[1] - _A13N * s[0]) % _M1
        s[0], s[1], s[2] = s[1], s[2], p1
        p2 = (_A21 * s[5] - _A23N * s[3]) % _M2
        s[3], s[4], s[5] = s[4], s[5], p2
        # RngStream.c U01: (p1 > p2) ? (p1-p2)*norm : (p1-p2+m1)*norm —
        # equality maps to ~1-eps, not ~0.
        return (p1 - p2) * _NORM if p1 > p2 else (p1 - p2 + _M1) * _NORM

    def rand_int(self, low: int, high: int) -> int:
        return low + int(self.rand_u01() * (high - low + 1))


def _derive_seed6(seed: int) -> List[int]:
    """Expand one integer into a valid 6-component RngStream seed
    (each in [1, m-1], so neither triple can be all-zero) with a
    splitmix64-style scrambler: avalanching, and distinct inputs give
    unrelated states."""
    out: List[int] = []
    x = int(seed) & 0xFFFFFFFFFFFFFFFF
    for i in range(6):
        x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z ^= z >> 31
        m = int(_M1) if i < 3 else int(_M2)
        out.append(int(z % (m - 1)) + 1)
    return out


def seeded_stream(seed: int, name: str = "") -> RngStream:
    """An RngStream at a reproducible state derived from an integer seed.

    Unlike a plain ``RngStream()`` construction, this does NOT consume a
    slot of the package-level stream sequence: components that seed
    explicitly (fault campaigns, retry policies) stay bit-reproducible
    no matter how many implicit streams were created before them."""
    saved = list(RngStream._next_seed)
    rng = RngStream(name)
    RngStream._next_seed = saved
    rng.set_seed(_derive_seed6(seed))
    return rng
