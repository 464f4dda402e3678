"""The op-cost probe: the counterpart of the TPU tools that hold the
Pallas kernels P1-P8 (``tools/tpu_pallas_probe.py``,
``tools/tpu_pallas_gather2.py``, ``tools/tpu_pallas_gather3.py``,
``tools/tpu_opcost.py``) and of ``tools/tpu_scaling_probe.py``, on the
hand-written kernels K12-K15.  It is on no path of the package: its
numbers (what a gather, a segment sum, a lane scan and a device-side
round loop cost on the card) inform the solver's kernels.

* :func:`simgrid_tpu_torch.probes.opcost.run_opcost` — P1-P8 and the
  op-cost table (modules ``pallas_probe``, ``pallas_gather2``,
  ``pallas_gather3``, ``opcost``);
* :func:`simgrid_tpu_torch.probes.scaling.run_scaling` — per-element
  against per-op cost;
* ``tools/torch_opcost.py`` — the command line over both.

Like every entry point of the port they run on the card unless the
caller passes ``device="cpu"`` (the plain versions, timed by the host).
"""
