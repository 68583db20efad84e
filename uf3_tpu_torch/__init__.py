"""
uf3_tpu_torch: the UF3 potential and MD engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``uf3_tpu`` (the JAX reference, kept beside it): the same
models, inputs and layouts, with torch tensors on the CUDA card by
default.  Nothing here imports ``uf3_tpu``, jax, pandas, PyYAML or
h5py: the host modules it needs are trimmed copies under the same
module names.

  data/               Atoms + bulk, elements, chemical system,
                      extended-xyz io and training sources, crystal
                      symmetry
  representation/     B-spline basis (with the fitting trims and the
                      regularizer), knot spacers, de Boor values, the
                      host featurizer and the HDF5 feature store
  regression/         WeightedLinearModel: Gram matrices on the device,
                      the solve on the host; regularizer matrices
  util/json_io.py     model file reader and writer
  util/hdf5.py        the HDF5 subset of the feature store, read and
                      written without h5py
  util/user_config.py settings of the fit commands
  forcefield/units.py eV / A / amu units
  io.py               model JSON -> basis + coefficients
  ops/splines.py      closed-form B-spline primitives
  ops/spline_jax.py   B-splines on general knots, polynomial tables
  ops/factorized.py   FactorizedPotential and the general force path
                      (any species, 2-body only, any knots)
  ops/potential.py    UF3Potential (nn.Module with the coefficients)
  ops/neighbors.py    O(N^2), images and cell-list neighbor lists,
                      filter, reverse slots
  ops/featurize.py    device featurization of configurations and
                      datasets (unary; multi-species configurations)
  ops/pair.py         switched 2-body forces and virial
  ops/trio.py         3-body kernel wrapper, torch twin, assembly,
                      virial, shared-gather and r-RESPA short forces
  ops/_build.py       nvcc build + ctypes loading of csrc/*.cu
  csrc/trio.cu        the 3-body CUDA kernel (with a center weight)
  forcefield/md.py    MD: velocity Verlet, 2- and 3-level r-RESPA
                      (NVE / Langevin / Nose-Hoover), SCR and
                      Berendsen NPT, stress, capacity regrowth, the
                      queued overflow check
  forcefield/calculator.py  UFCalculator: energy, forces, stress on
                      the engine's force routes
  forcefield/optimize.py, batch.py, properties/  FIRE and cell
                      relaxation, batch drivers, checkpoints,
                      trajectories, elastic constants, phonons
  forcefield/lammps.py  LAMMPS export and UFLammps (native backend)
  parallel/           torch.distributed shard mesh (ppermute, psum,
                      pmax, all_gather), sharded Gram and fits,
                      replicated-positions MD, halo-exchange slab MD
  __main__.py         python -m uf3_tpu_torch {featurize,fit,predict}
                      settings.json, {md,export} model.json
"""
