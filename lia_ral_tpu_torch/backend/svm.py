"""Kernel SVM (C-SVC) for GMM-supervector speaker models (port of
lia_ral_tpu/backend/svm.py).

Replacement for the reference's bundled libsvm (``LIA_Utils/Svm``: C_SVC
setup Svm.cpp:91-119 — linear kernel by default, C defaulting to
1/avg‖x‖², optional target-class penalty for the 1-target-vs-cohort NIST
setup).  The SMO solver is replaced, as in the JAX package, by FISTA
projected-gradient ascent on the dual with an exact bisection projection.

That solver is 16 power steps and 500 FISTA steps of a 50-step
bisection each: in the JAX package one ``jax.jit`` executable of two
nested ``lax.scan`` loops.  Written as eager PyTorch it would be some
2·10⁵ tiny launches a target, so a CUDA tensor goes through a
hand-written kernel, ``dual_solve_cuda`` (``csrc/svm_dual.cu``), that runs
the whole loop in one launch: Q = K∘yyᵀ formed once and held on chip,
each projection's bisection as 10 rounds of a 31-candidate tree.  Where Q
goes is the host's plan (``solve_plan``): in one thread block's shared
memory up to ``RESIDENT_LIMIT`` vectors (one warp up to 64), a slice of
its rows in each block of a thread-block cluster above that, and streamed
through each block's ring of column tiles from a scratch copy in device
memory where the slices do not fit.  A CPU tensor goes through
``dual_solve_reference``, the same loop op for op.  Dispatch is on the
tensor's device, with no fallback: a CUDA tensor launches the kernel or
raises.  ``launch_counts["svm_dual"]`` counts the kernel's launches (one
per launch, nothing else adds to it).

C, the support selection, the bias and the support rows are computed on
the training vectors' device: on a card a solve reads one small tensor
back (the support count and the bias), and its model keeps its support
rows and α·y there; off the card they are numpy arrays, as in the JAX
package.

``svm_train`` with the linear kernel solves on the training vectors
translated by their mean, where the JAX package solves on them as given.
GMM supervectors (KL or means) share a large common part, the world's
own means: it adds an eigenvalue of about N·‖m‖² to Q along y, which the
constraint yᵀα = 0 removes from the problem but which still sets the
step 1/λ_max(Q), so 500 FISTA steps leave α far from the optimum.  For
α with yᵀα = 0, αᵀQα does not change under a translation of the
vectors, so the optimum is the same; the bias absorbs −w·m, and the
model keeps the raw support vectors and its decision formula.  C stays
``default_c`` of the raw vectors (LIA's getC), its sums taken in
float64.  The rbf kernel is translation-invariant; the poly kernel is
solved as given.  The support vectors are those with α over 1e-6·C, the
bias's own bound: the float32 projection on the card can lift every zero
α over a smaller one, and the model then kept every training vector.
Dropping them moves yᵀα off 0, which the raw vectors' common part would
carry into every score, so it is restored over the free vectors in
float64.

Spans and counters (``utils.logging``, on only while a profiler
records): ``lia.svm.train`` ⊃ ``lia.svm.bounds`` (the mean, the rows'
float64 sums, C and the bounds), ``lia.svm.gram`` (the translation and
the kernel matrix), ``lia.svm.dual`` (the solve alone),
``lia.svm.model`` (the support selection, the bias, the one host read
and the gather of the support rows); ``lia.svm.decision``; the
``lia.svm.*`` counters say what each counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.logging import count, span

MAX_VECTORS = 8192              # the most training vectors of a problem
POWER_STEPS, BISECTION_STEPS = 16, 50
TREE_LEVELS = 5                 # bisection levels a round of the kernel
launch_counts = {"svm_dual": 0}

# the kernel's layout (csrc/svm_dual.cu): shared memory a block may use;
# the broadcast vector, the warps' and the blocks' exchange buffers (in
# floats); a thread owns two rows; a cluster has at most 16 blocks.  A
# copy, so that the plan is made without a card; the library's
# lia_svm_shared_bytes / lia_svm_shared_limit give the kernel's own
# figures, and the card tests hold every plan's to them
SMEM_BYTES = 232_448
EXCHANGE_FLOATS = 2 * 32 * 32 + 2 * 16 * 32
MAX_CLUSTER = 16
MAX_THREADS = 256
MIN_TILE, STREAM_THREADS = 32, 128


def row_stride(cols: int) -> int:
    """Floats a row of Q takes in shared memory: ``cols`` rounded up to a
    multiple of 4 whose quarter is odd, so eight lanes' 16-byte reads of
    eight consecutive rows fall in eight bank groups."""
    s = -(-cols // 4) * 4
    return s + 4 if (s // 4) % 2 == 0 else s


def _threads(rows: int) -> int:
    return -(-rows // 64) * 32            # two rows a thread, whole warps


def _resident_bytes(n: int, rows: int) -> int:
    vlen = -(-n // 4) * 4
    return 4 * (vlen + EXCHANGE_FLOATS + rows * row_stride(vlen))


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """How ``csrc/svm_dual.cu`` runs one problem of N vectors: a cluster
    of ``cluster`` blocks of ``threads`` threads, ``rows`` rows of Q a
    block, Q's slices ``resident`` in shared memory or streamed in
    ``tile`` columns at a time (then ``vec_len`` floats a row of the
    scratch copy); ``smem`` bytes of shared memory a block."""
    regime: str             # "one-warp", "one-block", "cluster", "streaming"
    cluster: int
    threads: int
    rows: int
    resident: bool
    tile: int
    vec_len: int
    smem: int


def solve_plan(n: int, max_cluster: int = MAX_CLUSTER) -> SolvePlan:
    """The kernel's plan for N training vectors: Q whole in one block
    where it fits (``RESIDENT_LIMIT``; one warp up to 64 vectors), else
    the smallest cluster whose blocks hold their slices of Q's rows, else
    the largest cluster the card co-schedules (``max_cluster``) streaming
    its slices in the widest power-of-two column tiles (at least 32) whose
    two-stage ring fits beside the vector."""
    if not 1 <= n <= MAX_VECTORS:
        raise ValueError(f"svm dual solve: N = {n} outside "
                         f"1..{MAX_VECTORS}")
    vlen = -(-n // 4) * 4
    for cs in range(1, max(max_cluster, 1) + 1):
        rows = -(-n // cs)
        if _resident_bytes(n, rows) <= SMEM_BYTES:
            regime = ("cluster" if cs > 1 else
                      "one-warp" if n <= 64 else "one-block")
            return SolvePlan(regime, cs, _threads(rows), rows, True, 0,
                             vlen, _resident_bytes(n, rows))
    cs = max_cluster
    rows = -(-n // cs)
    threads = max(_threads(rows), STREAM_THREADS)
    tile = MIN_TILE
    best = None
    while tile < n:
        vlen = -(-n // tile) * tile
        smem = 4 * (vlen + EXCHANGE_FLOATS + 2 * rows * (tile + 4))
        if smem > SMEM_BYTES:
            break
        best = SolvePlan("streaming", cs, threads, rows, False, tile, vlen,
                         smem)
        tile *= 2
    if best is None or threads > MAX_THREADS:
        raise ValueError(f"svm dual solve: N = {n} needs a cluster of more "
                         f"than the {max_cluster} blocks this card "
                         "co-schedules")
    return best


RESIDENT_LIMIT = max(n for n in range(1, 512)
                     if _resident_bytes(n, n) <= SMEM_BYTES)
_max_cluster: list = []


def card_max_cluster() -> int:
    """The largest cluster of the kernel that the card co-schedules (the
    kernel library's ``cudaOccupancyMaxActiveClusters`` query, once)."""
    if not _max_cluster:
        from .._build import library

        _max_cluster.append(int(library("svm_dual").lia_svm_max_cluster(
            MAX_THREADS)))
    return _max_cluster[0]


def reset_launch_counts() -> None:
    launch_counts["svm_dual"] = 0


def kernel_matrix(x: torch.Tensor, y: torch.Tensor, kind: str = "linear",
                  degree: int = 1, gamma: float = 0.0,
                  coef0: float = 0.0) -> torch.Tensor:
    """libsvm kernel types 0-2 (reference kernelType config key)."""
    if kind == "linear":
        return x @ y.T
    if kind == "poly":
        g = gamma if gamma > 0 else 1.0 / x.shape[1]
        return (g * (x @ y.T) + coef0) ** degree
    if kind == "rbf":
        g = gamma if gamma > 0 else 1.0 / x.shape[1]
        d2 = (torch.sum(x * x, 1)[:, None] + torch.sum(y * y, 1)[None, :]
              - 2.0 * x @ y.T)
        return torch.exp(-g * d2)
    raise ValueError(f"unknown kernel {kind}")


@dataclasses.dataclass
class SvmModel:
    """A trained C-SVC.  ``support`` and ``alpha_y`` are tensors on the
    card that trained it, numpy arrays off it (and when loaded from a
    file)."""
    support: np.ndarray | torch.Tensor      # (N, D) training vectors
    alpha_y: np.ndarray | torch.Tensor      # (N,) α_i·y_i
    bias: float
    kind: str = "linear"
    degree: int = 1
    gamma: float = 0.0
    coef0: float = 0.0

    def decision(self, x: torch.Tensor) -> torch.Tensor:
        """Decision values of the rows of x, on x's device."""
        with span("lia.svm.decision"):
            x = torch.as_tensor(x, dtype=torch.float32)
            sup = _moved(self.support, x.device)
            ay = _moved(self.alpha_y, x.device)
            k = kernel_matrix(x, sup, self.kind, self.degree, self.gamma,
                              self.coef0)
            return k @ ay + self.bias

    def host(self) -> "SvmModel":
        """This model with ``support`` and ``alpha_y`` as numpy arrays, as
        a file holds them: a card model's are read to the host."""
        cpu = torch.device("cpu")
        return dataclasses.replace(
            self, support=_moved(self.support, cpu).numpy(),
            alpha_y=_moved(self.alpha_y, cpu).numpy())


def _moved(a, dev: torch.device) -> torch.Tensor:
    """``a`` as a float32 tensor on ``dev``; a copy from the host to a card
    counts its bytes, a read from a card to the host its bytes and a host
    sync."""
    t = torch.as_tensor(a, dtype=torch.float32)
    if t.device == dev:
        return t
    if dev.type == "cpu":
        count("lia.svm.d2h_bytes", 4 * t.numel())
        count("lia.svm.host_syncs")
    elif t.device.type == "cpu":
        count("lia.svm.h2d_bytes", 4 * t.numel())
    return t.to(dev)


def default_c(x: np.ndarray) -> float:
    """Reference getC (Svm.cpp:75-84): C = 1/mean‖x‖²."""
    return float(1.0 / max(np.mean(np.sum(x * x, axis=1)), 1e-12))


def _project(a: torch.Tensor, y: torch.Tensor, c_vec: torch.Tensor
             ) -> torch.Tensor:
    """Exact projection onto {0 ≤ α ≤ C} ∩ {αᵀy = 0}: α(λ) = clip(a −
    λ·y, 0, C), g(λ) = α(λ)ᵀy is non-increasing in λ → 50 bisection
    steps over (−span, span), span = max|a| + max C + 1."""
    c_max = torch.amax(c_vec, dim=-1, keepdim=True)
    span = torch.amax(torch.abs(a), dim=-1, keepdim=True) + c_max + 1.0
    lo, hi = -span, span
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        g = torch.sum(torch.minimum(torch.clamp(a - mid * y, min=0.0), c_vec)
                      * y, dim=-1, keepdim=True)
        pos = g > 0.0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    lam = 0.5 * (lo + hi)
    return torch.minimum(torch.clamp(a - lam * y, min=0.0), c_vec)


def dual_solve_reference(k: torch.Tensor, y: torch.Tensor,
                         c_vec: torch.Tensor, n_iter: int = 500
                         ) -> torch.Tensor:
    """Projected-gradient ascent on the C-SVC dual: max Σα − ½·αᵀ·Q·α
    s.t. 0 ≤ α_i ≤ C_i, Σ α_i·y_i = 0, with Q = y·yᵀ ∘ K — the JAX
    ``_dual_solve`` op for op (the CPU path, and what ``dual_solve_cuda``
    is held against).  k (N, N) or (B, N, N), y and c_vec (N,) or (B, N);
    returns α of y's shape.

    Step size 1/λ_max(Q) from 16 power steps from v₀ = 1/N; then
    ``n_iter`` FISTA steps mom = α + ((t−1)/(t+2))(α − α_prev),
    α ← project(mom + lr·(1 − Q·mom)), t from 1; then a final
    ``project(α)``."""
    q = k * (y[..., :, None] * y[..., None, :])
    n = q.shape[-1]
    v = torch.ones_like(y) / n

    def matvec(vec):
        return (q @ vec[..., None])[..., 0]

    for _ in range(POWER_STEPS):
        v = matvec(v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                     keepdim=True),
                            min=1e-12)
    lam_max = torch.abs(torch.sum(v * matvec(v), dim=-1, keepdim=True))
    lr = 1.0 / torch.clamp(lam_max, min=1e-8)
    alpha = torch.zeros_like(y)
    alpha_prev = alpha
    t = 1.0
    for _ in range(n_iter):
        f = float(np.float32(t - 1.0) / np.float32(t + 2.0))   # f32, as JAX
        mom = alpha + f * (alpha - alpha_prev)
        grad = 1.0 - matvec(mom)
        alpha, alpha_prev = _project(mom + lr * grad, y, c_vec), alpha
        t += 1.0
    return _project(alpha, y, c_vec)


def dual_solve_cuda(k: torch.Tensor, y: torch.Tensor, c_vec: torch.Tensor,
                    n_iter: int = 500) -> torch.Tensor:
    """The CUDA kernel of ``csrc/svm_dual.cu``: the same solve as
    ``dual_solve_reference``, one launch for B problems, each on the
    blocks of its ``solve_plan`` (one block up to ``RESIDENT_LIMIT``
    vectors, a cluster above).  k (N, N) or (B, N, N), y and c_vec (N,) or
    (B, N): contiguous f32 CUDA tensors, N ≤ ``MAX_VECTORS``."""
    for label, t in (("k", k), ("y", y), ("c_vec", c_vec)):
        if t.device.type != "cuda":
            raise ValueError(f"dual_solve_cuda: {label} on {t.device} has "
                             "no kernel")
        if t.dtype != torch.float32:
            raise TypeError(f"dual_solve_cuda: {label} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dual_solve_cuda: {label} must be contiguous")
    batched = k.dim() == 3
    kb = k if batched else k[None]
    yb = y if batched else y[None]
    cb = c_vec if batched else c_vec[None]
    b, n = yb.shape
    if kb.shape != (b, n, n) or cb.shape != (b, n) or n < 1 \
            or len({kb.device, yb.device, cb.device}) != 1:
        raise ValueError(f"dual_solve_cuda: k {tuple(k.shape)}, y "
                         f"{tuple(y.shape)}, c_vec {tuple(c_vec.shape)} do "
                         "not describe B problems of N vectors on one "
                         "device")
    if n > MAX_VECTORS:
        raise ValueError(f"dual_solve_cuda: {n} training vectors exceed "
                         f"the kernel's {MAX_VECTORS}")
    from .._build import library

    dev = kb.device
    with torch.cuda.device(dev):
        lib = library("svm_dual")
        plan = solve_plan(n, card_max_cluster())
        alpha = torch.empty((b, n), dtype=torch.float32, device=dev)
        qbuf = (None if plan.resident else
                torch.empty((b, n, plan.vec_len), dtype=torch.float32,
                            device=dev))
        err = lib.lia_svm_dual(
            kb.data_ptr(), yb.data_ptr(), cb.data_ptr(), alpha.data_ptr(),
            None if qbuf is None else qbuf.data_ptr(), b, n, n_iter,
            plan.cluster, plan.threads, plan.rows, plan.tile,
            int(plan.resident), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dual_solve_cuda: CUDA kernel launch failed "
                           f"(cudaError {err}, plan {plan})")
    launch_counts["svm_dual"] += 1
    return alpha if batched else alpha[0]


def _dual_solve(k: torch.Tensor, y: torch.Tensor, c_vec: torch.Tensor,
                n_iter: int = 500) -> torch.Tensor:
    """α of the C-SVC dual: the kernel for a CUDA tensor, the plain loop
    for a CPU one."""
    if k.device.type == "cpu":
        return dual_solve_reference(k, y, c_vec, n_iter)
    dev = k.device
    return dual_solve_cuda(k.contiguous(), y.to(dev).contiguous(),
                           c_vec.to(dev).contiguous(), n_iter)


# elements a float64 block of ``_row_sums`` holds (256 MiB): enough work
# a block that the card, not the launches, sets the pace
F64_BLOCK = 1 << 25


def _row_sums(x: torch.Tensor, v: torch.Tensor | None, squares: bool):
    """‖x_i‖² (where ``squares``) and x_i·v (where v is given) of the rows
    of x, in float64 with exact products, a block of rows at a time so
    that the float64 copy stays small."""
    n, d = x.shape
    f64 = {"dtype": torch.float64, "device": x.device}
    sq = torch.empty(n, **f64) if squares else None
    xm = torch.empty(n, **f64) if v is not None else None
    if sq is None and xm is None:
        return sq, xm
    m = v.double() if v is not None else None
    rows = max(1, F64_BLOCK // max(d, 1))
    for i in range(0, n, rows):
        blk = x[i:i + rows].double()
        if xm is not None:
            torch.mv(blk, m, out=xm[i:i + rows])
        if sq is not None:
            torch.sum(blk.square_(), dim=1, out=sq[i:i + rows])
    return sq, xm


def svm_train(x, y, c: float | None = None,
              target_penalty: float | None = None, kind: str = "linear",
              degree: int = 1, gamma: float = 0.0, coef0: float = 0.0,
              n_iter: int = 500) -> SvmModel:
    """Train a C-SVC (reference Svm.cpp svm_train call site cpp:339).

    x (N, D): a tensor (the solve runs on its device) or a numpy array
    (on the CPU); y ∈ {+1,−1}; ``target_penalty`` multiplies C for the +1
    class (reference targetPenalty for unbalanced 1-vs-cohort data).  The
    linear kernel is solved on the vectors less their mean (the module's
    docstring says why); the model holds the raw support vectors.  All
    of it runs on x's device, which a solve waits on once: for the
    support count and the bias."""
    with span("lia.svm.train"):
        xt = torch.as_tensor(x, dtype=torch.float32)
        n = xt.shape[0]
        dev = xt.device
        with span("lia.svm.bounds"):
            yt = torch.as_tensor(y, dtype=torch.float32)
            if yt.device != dev:
                count("lia.svm.h2d_bytes", 4 * yt.numel())
                # from page-locked memory: the copy waits for nothing
                # queued before it
                yt = yt.pin_memory().to(dev, non_blocking=True)
            centre = xt.mean(dim=0) if kind == "linear" else None
            sq, xm = _row_sums(xt, centre, c is None)
            # C = 1/mean‖x‖² (``default_c``, LIA's getC) unless given
            c_t = (1.0 / torch.clamp(sq.mean(), min=1e-12) if c is None
                   else torch.full((), float(c), dtype=torch.float64,
                                   device=dev))
            c32 = c_t.float()
            tp = 1.0 if target_penalty is None else target_penalty
            c_vec = torch.where(yt > 0, c32 * tp, c32)
        with span("lia.svm.gram"):
            xs = xt if centre is None else xt - centre
            k = kernel_matrix(xs, xs, kind, degree, gamma, coef0)
            del xs
        with span("lia.svm.dual"):
            alpha_t = _dual_solve(k, yt, c_vec, n_iter=n_iter)
        count("lia.svm.solves")
        count("lia.svm.vectors", n)
        count("lia.svm.q_entries", n * n)
        count("lia.svm.dual_steps", n_iter * n * n)
        count("lia.svm.dual_step_vectors", n_iter * n)
        with span("lia.svm.model"):
            y64 = yt.double()
            # α at or under 1e-6·C is 0 (the float32 projection can lift
            # every zero α a little); yᵀα = 0 is then restored over the
            # free vectors, 0 < α < C, in float64
            alpha = alpha_t.double()
            keep = alpha > 1e-6 * c_t
            alpha = torch.where(keep, alpha, 0.0)
            on_margin = keep & (alpha < c_vec * (1 - 1e-6))
            n_margin = on_margin.sum()
            per = torch.clamp(n_margin, min=1)
            alpha = torch.where(on_margin,
                                alpha - (alpha @ y64) * y64 / per, alpha)
            ay = alpha.float() * yt             # 0 off the support
            # bias from margin support vectors (0 < α < C), else from all;
            # K(α·y) in float64, a block of K's rows at a time
            resid = y64 - _row_sums(k, ay, False)[1]
            bias = torch.where(n_margin > 0,
                               torch.where(on_margin, resid, 0.0).sum() / per,
                               resid.mean())
            if xm is not None:
                # the raw vectors' decision: w·x + bias − w·m
                bias = bias - ay.double() @ xm
            # the solve's one host read
            n_sup, bias = torch.stack([keep.sum().double(), bias]).tolist()
            n_sup = int(n_sup)
            count("lia.svm.host_syncs")
            if dev.type != "cpu":
                count("lia.svm.d2h_bytes", 16)
            rows = torch.nonzero_static(keep, size=n_sup)[:, 0]
            model = SvmModel(support=xt.index_select(0, rows),
                             alpha_y=ay.index_select(0, rows), bias=bias,
                             kind=kind, degree=degree, gamma=gamma,
                             coef0=coef0)
            count("lia.svm.support", n_sup)
    return model if dev.type != "cpu" else model.host()
