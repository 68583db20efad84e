"""
The port's user entry points, each run as ``python -m
uf3_tpu_torch.examples.<name> ... [--cpu]`` (on the CUDA card unless
``--cpu``), each with a ``main(argv=None)``:

- ``melting_point``: a two-phase melting-point trial of bcc W;
- ``tungsten_fit``: the 2+3-body W fit on an extended-xyz dataset;
- ``nexe_pair_fit``: the binary Ne-Xe pair fit on a LAMMPS run, and its
  ``pair_style table`` files;
- ``multichip_demo``: halo-exchange MD and a sharded fit over a
  ``torch.distributed`` group.
"""
