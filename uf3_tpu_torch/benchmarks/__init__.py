"""
Measurement scripts of the port, run as modules on the card
(``python -m uf3_tpu_torch.benchmarks.<name>``), each writing a JSON
artifact under ``benchmarks_data/artifacts_torch/``:

- ``step_anatomy``: the MD inner step's cumulative prefixes, each body
  chained 30 times in one CUDA graph (device time) and run eagerly
  (host time), after ``benchmarks/step_anatomy.py``;
- ``probe_gather``: the neighbor-gather kernels of ``ops/gather.py``
  at the shapes and index types of the TPU gather probes, beside the
  library call and the plain version;
- the main path's physics checks, after the scripts of the same names
  under ``benchmarks/``: ``validate_final`` (the long-horizon NVE of an
  r-RESPA cadence), ``validate_respa`` and ``validate_respa_mid`` (NVE
  drift per r-RESPA depth and mid cadence), ``probe_stale`` (what trips
  the staleness flag) and ``probe_stale_error`` (the force error of a
  frozen neighbor list at the stale trip line);
- the other measurement scripts of ``benchmarks/``: ``anatomy_3l`` (the
  3-level r-RESPA step's phases, device against host, and its cycle
  model), ``probe_rebuild2`` (the full neighbor rebuild by size),
  ``md_scaling`` (the MD rate against N), ``featurize_throughput`` and
  ``fit_wallclock`` (the fit path's times) and ``melting_run`` (the
  melting-point bracket over the example's trials);
- the headline scripts: ``bench`` (the bench path's atom-steps/s, after
  the root ``bench.py``; it prints one line and writes no artifact),
  ``throughput_gate`` (the same windows, a per-phase breakdown and a
  threshold) and ``budget_step`` (the step's work counted from the
  port's code, its floor at the card's peaks, and the measured step's
  share of them).
"""
