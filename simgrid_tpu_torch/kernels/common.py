"""State shared by the kernels and their plain PyTorch versions.

The drain keeps its solver and flow state on the device, as the JAX
package does, so that the host can queue many kernel launches and wait
for the device once per superstep.  Control words that the JAX programs
keep in ``lax.while_loop`` carries (round counter, light-constraint
count, superstep advance and round counters, flags) live here in one
small int32 tensor ``ctrl`` and one dtype tensor ``fctrl``.  The loops
themselves run on the card (K16, ``superstep_loop.py``): their
conditions read these words, and every kernel reads them first too and
returns at once when its replica has nothing to do.
The slot numbers below are mirrored in ``csrc/common.cuh``.

A fleet of B replicas (``Work(..., B=B)``) gives every per-replica
tensor a leading replica axis (``ctrl`` is ``[B, N_CTRL]``, ``v_value``
``[B, n_v]``, the ``atomicMin`` bit slots ``[B, 1]``, ...), so that one
launch serves every replica and each replica's kernel guards read its
own control words.  The default ``B=None`` is the solo layout of
earlier callers; its memory is that of a fleet of one.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from ..ops.csr import Csr

# ---- ctrl (int32) slots; keep in sync with csrc/common.cuh ----
IT = 0            # rounds run by the current fixpoint
LIGHT = 1         # light (still active) constraints after the last round
LIGHT_ACC = 2     # light count being accumulated by the running round
LIMIT = 3         # the fixpoint runs while IT < LIMIT
ARMED = 4         # the current fixpoint was initialised and may run
SS_ACTIVE = 5     # the current superstep advance slot runs
SS_ADV = 6        # advances committed in this superstep
SS_ROUNDS = 7     # rounds spent in this superstep
SS_FLAG = 8       # FLAG_OK / FLAG_STALLED / FLAG_BUDGET
SS_NEV = 9        # completions logged in the ring
SS_NLIVE = 10     # live flows after the last advance
SS_K = 11         # advances asked of this superstep
SS_BUDGET = 12    # round budget of this superstep
SS_STOP = 13      # stop once live flows <= this
#: slot 14 is free
LIVE_ACC = 15     # live flows counted by the last advance
ADV_GO = 16       # the last advance ran
ADV_CONV = 17     # the fixpoint it read had converged
LE_ACC = 18       # live elements counted at the end of a superstep
VLIVE = 19        # live variables after the last vc round (K8)
VLIVE_ACC = 20    # live variables being counted by the running vc round
HALF = 21         # a vc round runs only while VLIVE > HALF (-1: always)
OVERFLOW = 22     # a compaction-chain stage ended with too many live rows
NFIXED_ACC = 23   # fixed variables counted by the chain's fetch
TPOS = 24         # fault-tape cursor: the first entry not yet fired
FIRE = 25         # the last advance landed on an event date
FFIRE = 26        # ... and the event is the next fault-tape entry
AANY = 27         # ... and the event is a collective activation date
PENDING = 28      # collective flows with a pending activation date
ADV_OK = 29       # the last advance committed (converged, finite dt)
#: slots 30-31: one 64-bit ticket by which a launch's last block finds
#: itself (K2, K3); 0 between launches
TICKET = 30
N_CTRL = 32

# ---- fctrl (dtype) slots ----
T_SUM = 0
T_COMP = 1
DT = 2
N_FCTRL = 4

# ---- evf (float64) slots: the superstep's event clock ----
EV_T0 = 0         # the host clock the superstep starts from
EV_NEXT_T = 1     # the date of the event the last advance looked at
N_EVF = 2

MAX_ROUNDS = 100_000

#: flags a block of K3's commit covers (csrc/superstep_commit.cu)
COMMIT_TILE = 4096
#: the head of a replica's commit scratch row, before the tile counts
COMMIT_HEAD = 4


def commit_tiles(n_v: int) -> int:
    return max(1, -(-n_v // COMMIT_TILE))


def inf_key(dtype: torch.dtype) -> int:
    """The bits of +inf in ``dtype`` (f32 or f64), as K2's ``atomicMin``
    slots hold them between calls."""
    return 0x7FF0000000000000 if dtype == torch.float64 else 0x7F800000

FLAG_OK = 0
FLAG_STALLED = 1
FLAG_BUDGET = 2


class LmmSystem(NamedTuple):
    """The device copy of a flattened system: COO elements (padded with
    weight-0 entries), constraint bounds, both row indexes, and the
    FATPIPE flags (None: every constraint is SHARED)."""
    e_var: torch.Tensor    # [E] int32
    e_cnst: torch.Tensor   # [E] int32
    e_w: torch.Tensor      # [E] dtype
    c_bound: torch.Tensor  # [C] dtype
    csr: Csr
    n_v: int
    c_fatpipe: Optional[torch.Tensor] = None   # [C] bool

    @property
    def n_c(self) -> int:
        return int(self.c_bound.shape[-1])

    @property
    def n_e(self) -> int:
        return int(self.e_var.shape[0])

    def replica(self, b: int) -> "LmmSystem":
        """Replica ``b`` of a fleet system (``c_bound`` [B, C], ``e_w``
        [E] shared or [B, E]), as a solo system of views."""
        return self._replace(
            c_bound=self.c_bound[b] if self.c_bound.dim() == 2
            else self.c_bound,
            e_w=self.e_w[b] if self.e_w.dim() == 2 else self.e_w)


class Work:
    """Fixpoint state, per-round scratch and control words of one
    system size (``n_v`` variables, ``n_c`` constraints).

    The bound arm's scratch (``low_v``, ``mb_v``, ``level2_v`` per
    variable, ``mb_c``, ``blocked_c`` per constraint) and the global
    arm's ``rou`` and its two grid-wide minima (``min_usage``,
    ``min_bound``: the bits of a non-negative float, as ``dtbits``) are
    written by the rounds that use them and read by nothing else.
    K2's minimum slots ``dtbits`` (dt, in the drain's dtype) and
    ``atbits`` (the earliest activation date, f64) hold the bits of +inf
    between calls: each call's last block resets them.  ``commit_scan``
    is K3's scratch (the bases of a commit's ring entries and its tiles'
    counts), written and read within one commit.
    ``touch`` marks the constraints a round's fixed variables lie on
    (K1 sets and clears it within one round), ``k1_plan`` holds K1's row
    plan of the last row index it ran on (``kernels/lmm_round.py``
    ``plan_of``), ``c_mod`` is K6's scratch (the modified-constraint
    mask), and
    ``carry_valid`` says whether the state holds a converged solve that
    a warm restart may start from (the JAX warm solver's ``carry`` is
    not None)."""

    def __init__(self, n_v: int, n_c: int, dtype: torch.dtype,
                 device: torch.device, B: Optional[int] = None):
        #: replicas of a fleet (None: the solo layout)
        self.B = B

        def vec(n, dt):
            shape = (n,) if B is None else (B, n)
            return torch.zeros(shape, dtype=dt, device=device)
        self.v_value = vec(n_v, dtype)
        self.v_fixed = vec(n_v, torch.bool)
        self.nmin_v = vec(n_v, dtype)
        self.fix_now = vec(n_v, torch.bool)
        self.done = vec(n_v, torch.bool)
        self.remaining = vec(n_c, dtype)
        self.usage = vec(n_c, dtype)
        self.light = vec(n_c, torch.bool)
        self.proc = vec(n_c, torch.bool)
        self.low_v = vec(n_v, torch.bool)
        self.mb_v = vec(n_v, dtype)
        self.level2_v = vec(n_v, dtype)
        self.mb_c = vec(n_c, dtype)
        self.blocked_c = vec(n_c, torch.bool)
        self.rou = vec(n_c, dtype)
        self.min_usage = vec(1, torch.int64)
        self.min_bound = vec(1, torch.int64)
        self.ctrl = vec(N_CTRL, torch.int32)
        self.fctrl = vec(N_FCTRL, dtype)
        self.dtbits = vec(1, torch.int64).fill_(inf_key(dtype))
        #: the event arm's f64 clock words and min(ready) bits
        self.evf = vec(N_EVF, torch.float64)
        self.atbits = vec(1, torch.int64).fill_(inf_key(torch.float64))
        self.commit_scan = vec(COMMIT_HEAD + 2 * commit_tiles(n_v),
                               torch.int32)
        self.c_mod = vec(n_c, torch.bool)
        self.touch = vec(n_c, torch.bool)
        self.k1_plan = None
        self.carry_valid = False
        #: K1's pointer arrays by arm (kernels/lmm_round.py ``_ptrs``)
        self.ptr_cache: dict = {}

    @property
    def nb(self) -> int:
        """Replicas a launch serves (1 for the solo layout)."""
        return 1 if self.B is None else self.B

    def replica(self, b: int) -> "Work":
        """Replica ``b`` of a fleet's work, as a solo :class:`Work` of
        views (what the plain versions run on, one replica at a time)."""
        views = self.__dict__.setdefault("_views", {})
        r = views.get(b)
        if r is None:
            r = object.__new__(type(self))
            for k, v in vars(self).items():
                if k != "_views":
                    setattr(r, k, v[b] if isinstance(v, torch.Tensor)
                            else v)
            r.B = None
            r.ptr_cache = {}
            views[b] = r
        return r


class EllSystem(NamedTuple):
    """The device copy of an ELL system (``ops/lmm_ell.LmmEllArrays``):
    the constraint-row tables ``cv_*`` [C, Wc] and the variable-row
    tables ``vc_*`` [V, Wv], the constraint bounds and FATPIPE flags, and
    the constraint index over the flat variable-row positions
    (``vcx_ptr`` [C+1], ``vcx_idx``: for each constraint, the positions
    ``v * Wv + lane`` of its valid entries in increasing order), which
    K8 folds its per-constraint sums along."""
    cv_var: torch.Tensor    # [C, Wc] int32
    cv_w: torch.Tensor      # [C, Wc] dtype
    cv_valid: torch.Tensor  # [C, Wc] bool
    vc_cnst: torch.Tensor   # [V, Wv] int32
    vc_valid: torch.Tensor  # [V, Wv] bool
    vc_w: torch.Tensor      # [V, Wv] dtype
    c_bound: torch.Tensor   # [C] dtype
    c_fatpipe: torch.Tensor  # [C] bool
    vcx_ptr: torch.Tensor   # [C+1] int32
    vcx_idx: torch.Tensor   # [nnz] int32

    @property
    def n_c(self) -> int:
        return int(self.c_bound.shape[0])

    @property
    def n_v(self) -> int:
        return int(self.vc_cnst.shape[0])

    @property
    def wc(self) -> int:
        return int(self.cv_var.shape[1])

    @property
    def wv(self) -> int:
        return int(self.vc_cnst.shape[1])


class EllWork(Work):
    """A :class:`Work` with the ELL fixpoint's extra carry leg
    ``cv_live`` [C, Wc] (the constraint-row liveness mask
    ``apply_fixes`` maintains) and K6-ELL's per-variable scratch."""

    def __init__(self, n_v: int, n_c: int, wc: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__(n_v, n_c, dtype, device)
        self.cv_live = torch.zeros((n_c, wc), dtype=torch.bool,
                                   device=device)
        self.v_mod = torch.zeros(n_v, dtype=torch.bool, device=device)
        self.v_has = torch.zeros(n_v, dtype=torch.bool, device=device)


class LaunchCounter:
    """Launches of one hand-written kernel (incremented by its wrapper
    where it launches the kernel, and nowhere else)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return COUNTERS.setdefault(name, LaunchCounter(name))


def is_double(dtype: torch.dtype) -> int:
    if dtype == torch.float64:
        return 1
    if dtype == torch.float32:
        return 0
    raise TypeError(f"kernels take float32 or float64, not {dtype}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    if not t.is_cuda:
        raise ValueError("kernel argument is not on a CUDA device")
    if not t.is_contiguous():
        raise ValueError("kernel argument is not contiguous")
    return ctypes.c_void_p(t.data_ptr())


def opt_ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """``ptr`` of a tensor a kernel arm reads, or NULL when the arm is
    off and the caller has none."""
    return ctypes.c_void_p(None) if t is None else ptr(t)


def ptr_array(tensors) -> ctypes.Array:
    """One C array of pointers (``void**``) for kernels with many
    buffers; None entries become NULL."""
    return (ctypes.c_void_p * len(tensors))(*(opt_ptr(t).value
                                               for t in tensors))


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch "
                           f"(cudaError {rc})")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (run the plain version),
    False when all lie on a CUDA device (launch the kernel); a mix or
    another device raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel arguments on devices {sorted(kinds)}")


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
D = ctypes.c_double
