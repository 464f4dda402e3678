"""P4 on the card: the counterpart of ``tools/tpu_pallas_gather2.py``.

The tool gathers the 524,288 entries of ``idx [131072, 4]`` from a
16,384-entry table in four in-kernel forms (``buildA``-``buildD``,
``:69/81/93/106``).  Each computes ``tab[idx]`` in another layout of the
same index, so here each form is that layout of the index handed to
K12, on both arms, and the form itself, written with one PyTorch call,
is the library column:

* A ``A_tala_8xK``: ``idx`` as ``[8, E/8]``, ``take_along_axis`` on the
  table broadcast to ``[8, C]`` (``torch.gather``);
* B ``B_tala_64xK``: the same at ``[64, E/64]``;
* C ``C_rowgather``: ``idx [V, 4]`` into the table as ``[C, 1]``
  (``torch.take``);
* D ``D_tala_axis0``: ``idx`` as ``[E/128, 128]``, ``take_along_axis``
  along axis 0 on the table broadcast to ``[C, 128]``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..kernels.probe_gather import ARMS as GATHER_ARMS
from ..kernels.probe_gather import probe_gather
from . import data
from .common import DTYPES, Table, torch_dtype

FORMS = ("A_tala_8xK", "B_tala_64xK", "C_rowgather", "D_tala_axis0")


def layouts(idx, C: int) -> dict:
    """Each form's index layout (views of one contiguous ``idx``)."""
    return {"A_tala_8xK": idx.reshape(8, -1),
            "B_tala_64xK": idx.reshape(64, -1),
            "C_rowgather": idx,
            "D_tala_axis0": idx.reshape(-1, 128)}


def library_form(form: str, tab: torch.Tensor, idx_l: torch.Tensor):
    """The form as one PyTorch call (``idx_l`` the layout in int64)."""
    C = tab.shape[0]
    if form == "C_rowgather":
        return lambda: torch.take(tab, idx_l)
    if form == "D_tala_axis0":
        t = tab.reshape(C, 1).expand(C, 128)
        return lambda: torch.gather(t, 0, idx_l)
    t = tab.reshape(1, C).expand(idx_l.shape[0], C)
    return lambda: torch.gather(t, 1, idx_l)


def run(table: Table, scale: float = 1.0,
        dtypes: Sequence[str] = DTYPES) -> List[dict]:
    dev = table.device
    d = data.pallas_gather2(scale)
    C = d["C"]
    idx = torch.from_numpy(d["idx"]).to(dev)
    out = []
    for name in dtypes:
        dt = torch_dtype(name)
        tab_np = data.as_dtype(d["tab"], dt)
        tab = torch.from_numpy(tab_np).to(dev)
        es = tab.element_size()
        for form, lay in layouts(idx, C).items():
            want = tab_np[lay.cpu().numpy()]
            out += table.measure(
                "pallas_gather2", form, dt,
                {a: (lambda a=a, lay=lay: probe_gather(tab, lay, a))
                 for a in GATHER_ARMS},
                want, tab.numel() * es + lay.numel() * (4 + es),
                library=library_form(form, tab, lay.long()),
                library_name="torch.take" if form == "C_rowgather"
                else "torch.gather")
    return out
