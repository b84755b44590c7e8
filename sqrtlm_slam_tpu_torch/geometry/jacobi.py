"""Singular value decompositions that never read the device.

`torch.linalg.svd` checks its convergence on the host, and a captured CUDA
graph (`utils.cache`) cannot hold a read of the device. The SVDs of the
RANSAC banks (`geometry/align.py`'s 3x3 Umeyama, `algorithm/pnp.py`'s
12-column DLT and its 3x3 orthonormalisation) are therefore one-sided
(Hestenes) Jacobi iterations of a fixed number of sweeps in tensor ops: each
rotation orthogonalizes two columns of A V. It works on A itself, not on
A^T A, which would square the condition number.

The column pairs of a sweep follow the parallel (round-robin) ordering:
n - 1 rounds of n / 2 disjoint rotations (a zero column pads an odd n), each
round one batched tensor computation on adjacent column pairs followed by
one fixed column permutation, which brings the columns back to their order
after a whole sweep. The cyclic order would take n (n - 1) / 2 sequential
rotations a sweep, and as many groups of kernels in a graph.

The same functions run on every device: the eager body of a graphed
function and its capture are one function, and the CPU tests run it.
`pipeline/triangulation.py` keeps its own cyclic 4x4 (`_null_vector_4x4`):
another rotation order gives other bits.
"""

from __future__ import annotations

import functools

import torch

# Sweeps of the 12-column DLT and of the 3x3 SVDs. Convergence is quadratic
# once the columns are nearly orthogonal; these reach float32 rounding on
# the banks' matrices (tests/test_torch_reloc_graphs.py holds them against
# numpy's float64 SVD).
SWEEPS = 8
SWEEPS_3X3 = 5


@functools.lru_cache(maxsize=None)
def _round_permutation(n: int, device: torch.device) -> torch.Tensor:
    """The column permutation that follows each round, as an index into the
    round's output `cat([p columns, q columns])` (n even).

    The round-robin (circle) schedule: column 0 stays, the other n - 1 turn
    one place a round; round r pairs slots (2i, 2i + 1). Slot s of round 0
    holds column s: slot 1 holds circle place 0, slot 2k place k and slot
    2k + 1 place -k (mod n - 1). Made on `device` once per process."""
    m = n - 1
    place_of = [None] * n  # circle place of each slot's column (0 -> fixed)
    slot_of = {}
    place_of[1] = 0
    slot_of[0] = 1
    for k in range(1, n // 2):
        place_of[2 * k], place_of[2 * k + 1] = k % m, (-k) % m
        slot_of[k % m], slot_of[(-k) % m] = 2 * k, 2 * k + 1
    perm = [0] + [slot_of[(place_of[s] + 1) % m] for s in range(1, n)]
    half = n // 2
    # Slot t of the round's output lies at position t // 2 of the p block
    # (t even) or of the q block (t odd).
    src = [(t // 2) if t % 2 == 0 else half + t // 2 for t in perm]
    return torch.tensor(src, dtype=torch.long, device=device)


def _hestenes(A: torch.Tensor, sweeps: int):
    """One-sided Jacobi of (..., m, n) A: (W, V) with W = A V, the columns
    of W orthogonal and V orthogonal (..., n, n). A zero column pads an odd
    n during the sweeps and is dropped after."""
    m, n = A.shape[-2:]
    pad = n % 2
    if pad:
        A = torch.cat([A, torch.zeros_like(A[..., :1])], dim=-1)
    N = n + pad
    eye = torch.eye(N, dtype=A.dtype, device=A.device).expand(A.shape[:-2] + (N, N))
    X = torch.cat([A, eye], dim=-2)  # rows :m hold W = A V, rows m: hold V
    perm = _round_permutation(N, A.device)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    for _ in range(sweeps * (N - 1)):
        Xp, Xq = X[..., 0::2], X[..., 1::2]
        Wp, Wq = Xp[..., :m, :], Xq[..., :m, :]
        alpha = torch.sum(Wp * Wp, dim=-2)
        beta = torch.sum(Wq * Wq, dim=-2)
        gamma = torch.sum(Wp * Wq, dim=-2)
        # The rotation that zeroes each pair's inner product (none where it
        # is zero already, a padding column's).
        skip = gamma == 0
        zeta = (beta - alpha) / torch.where(skip, one, 2.0 * gamma)
        t = torch.where(zeta >= 0, one, -one) / (torch.abs(zeta)
                                                  + torch.sqrt(1.0 + zeta * zeta))
        t = torch.where(skip, torch.zeros_like(t), t)
        c = torch.rsqrt(1.0 + t * t)[..., None, :]
        s = c * t[..., None, :]
        X = torch.cat([c * Xp - s * Xq, s * Xp + c * Xq], dim=-1).index_select(-1, perm)
    return X[..., :m, :n], X[..., m:m + n, :n]


def null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of each
    (..., m, n) A, up to sign: (..., n)."""
    W, V = _hestenes(A, SWEEPS)
    j = torch.argmin(torch.linalg.vector_norm(W, dim=-2), dim=-1)
    return torch.gather(V, -1, j[..., None, None].expand(V.shape[:-1] + (1,)))[..., 0]


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices in closed form (the triple
    product of the rows)."""
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :], dim=-1),
                     dim=-1)


def _unit(v: torch.Tensor, norm: torch.Tensor, ok: torch.Tensor, fallback: torch.Tensor):
    return torch.where(ok[..., None], v / torch.where(ok, norm, torch.ones_like(norm))[..., None],
                       fallback)


def svd3(A: torch.Tensor):
    """SVD of (..., 3, 3) A: (U, S, V) with A = U diag(S) V^T, S descending
    and non-negative, U and V orthogonal, finite at any rank.

    U's first two columns are A's first two left singular vectors (a unit
    vector orthogonal to the first where A has rank 1, the x axis where A
    is zero); the third is u1 x u2, its sign that of A v3 along it (+1 at
    rank 2), so that a rank-2 covariance (a minimal set of three points)
    keeps a finite U."""
    W, V = _hestenes(A, SWEEPS_3X3)
    S = torch.linalg.vector_norm(W, dim=-2)
    S, order = torch.sort(S, dim=-1, descending=True, stable=True)
    W = torch.gather(W, -1, order[..., None, :].expand(W.shape))
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    w1, w2, w3 = W[..., :, 0], W[..., :, 1], W[..., :, 2]
    axes = torch.eye(3, dtype=A.dtype, device=A.device)
    tiny = torch.finfo(A.dtype).tiny
    u1 = _unit(w1, S[..., 0], S[..., 0] > tiny, axes[0].expand(w1.shape))
    # The axis least aligned with u1 completes it where A has rank 1.
    least = torch.argmin(torch.abs(u1), dim=-1)
    e = (torch.arange(3, device=A.device) == least[..., None]).to(A.dtype)
    c = torch.linalg.cross(u1, e, dim=-1)
    other = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    v2 = w2 - torch.sum(w2 * u1, dim=-1, keepdim=True) * u1
    n2 = torch.linalg.vector_norm(v2, dim=-1)
    u2 = _unit(v2, n2, n2 > 1e-6 * S[..., 0] + tiny, other)
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    sign3 = torch.where(torch.sum(w3 * u3, dim=-1) < 0, -1.0, 1.0).to(A.dtype)
    U = torch.stack([u1, u2, sign3[..., None] * u3], dim=-1)
    return U, S, V
