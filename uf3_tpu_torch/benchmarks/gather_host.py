"""
The host cost of this checkout's kernel wrappers beside another
checkout's: host microseconds per eager call of ``gather_rows``,
``gather_lanes``, ``rev_gather`` and ``trio_partials``, of the other
checkout's same wrappers and of the gathers' library calls
(``x[idx]``, ``torch.gather``, ``part[idx, rev]``), at the MD step's
9,826 x 16 and the plain Verlet defaults' 9,826 x 78 (float32 values,
int64 indices drawn from seed 0; ``rev_gather`` of (N, 16, 5) partials
and ``trio_partials`` without energy on the bench's float32 3-body rows
of bcc W 17^3 at 9,826 x 16 only).  What a caller in the host-bound MD
step would pay for a wrapper.

Both run in one process on the same operands: the other checkout's
``ops/gather.py`` and ``ops/trio.py`` are loaded under names of their
own on its own ``ops/_build.py`` (so its own kernel library, built in
that checkout).
Processes of their own swing by a fifth from one to the next on a shared
host, more than the difference sought; here every round times each call
once (30 calls, then a synchronize, best of 3 after a warm chain, as
``common.host_chain_ms`` times them), the order reversed every other
round.  A call's figure is its median over the rounds; beside it, the
median and quartiles of the per-round differences, this checkout's
wrapper less the other's.

    python -m uf3_tpu_torch.benchmarks.gather_host --against DIR

where ``DIR`` holds the other checkout (e.g. ``git archive`` of the
parent commit, unpacked).  Writes ``gather_host.json`` under
``--out-dir`` (the artifacts directory by default).  Needs a card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = ((9826, 16), (9826, 78))
LENGTH, REPEATS, ROUNDS = 30, 3, 20
IMPORT = "from uf3_tpu_torch.ops import _build"


def load_ops(root: str, names=("gather", "trio")) -> dict:
    """``root``'s ``uf3_tpu_torch/ops/<name>.py`` for each of ``names``,
    each as a module of its own name, on ``root``'s ``ops/_build.py``
    (its own C library, built under ``root``)."""
    ops = os.path.join(os.path.abspath(root), "uf3_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        "other_build", os.path.join(ops, "_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    modules = {}
    for name in names:
        path = os.path.join(ops, f"{name}.py")
        with open(path) as f:
            source = f.read()
        if IMPORT not in source:
            raise RuntimeError(f"{path} does not import _build as expected")
        module = types.ModuleType(f"other_{name}")
        module.__file__, module._build = path, build
        exec(compile(source.replace(IMPORT, ""), path, "exec"),
             module.__dict__)
        modules[name] = module
    return modules


def trio_operands(device):
    """(potential, d, valid) of the bench engine's float32 3-body rows at
    bcc W 17^3 (9,826 atoms, 16 slots), 300 K velocities from seed 0."""
    import torch
    from uf3_tpu_torch.benchmarks import common
    from uf3_tpu_torch.forcefield.md import MDSystem
    from uf3_tpu_torch.ops import neighbors as nb
    system = MDSystem(common.MODEL, common.bcc_w((17, 17, 17)),
                      dtype=torch.float32, device=device, **common.BENCH)
    state = system.init_state(temperature=300.0, seed=0)
    cache = nb.list_cache(state.nbr3, system.cell, torch.float32)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return system.potential, d, cache.valid


def host_us(fn, length: int = LENGTH, repeats: int = REPEATS) -> float:
    """Host us per call of ``fn``: ``length`` eager calls ended by a
    synchronize, the best of ``repeats`` after one warm chain."""
    import torch
    best = float("inf")
    for turn in range(repeats + 1):
        t0 = time.perf_counter()
        for _ in range(length):
            fn()
        torch.cuda.synchronize()
        if turn:
            best = min(best, (time.perf_counter() - t0) / length)
    return 1e6 * best


def quartiles(values) -> dict:
    """The median and quartiles of ``values`` (linear interpolation)."""
    xs = sorted(values)

    def at(q):
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
    return dict(q1=at(0.25), median=at(0.5), q3=at(0.75))


def summarize(times: dict) -> dict:
    """From per-round host us by call ("<kind> this", "<kind> other",
    "<kind> library"): each call's median, and for each kind the
    quartiles of this less other, round by round."""
    kinds = sorted({name.split()[0] for name in times})
    return dict(
        median_us={name: quartiles(t)["median"] for name, t in times.items()},
        this_less_other_us={kind: quartiles(
            [a - b for a, b in zip(times[f"{kind} this"],
                                   times[f"{kind} other"])])
            for kind in kinds})


def measure(against: str, rounds: int = ROUNDS) -> dict:
    """Per shape, the rounds' host us of every call and their summary
    (``summarize``)."""
    import numpy as np
    import torch
    from uf3_tpu_torch.ops import gather, trio
    others = load_ops(against)
    other = others["gather"]
    device = torch.device("cuda")
    pot, d3, valid3 = trio_operands(device)
    rng = np.random.RandomState(0)
    out = {}
    for n, k in SHAPES:
        x = torch.as_tensor(rng.randn(n, 3), dtype=torch.float32,
                            device=device)
        idx = torch.as_tensor(rng.randint(0, n, size=(n, k)), device=device)
        t = torch.as_tensor(rng.randn(n, k), dtype=torch.float32,
                            device=device)
        li = torch.as_tensor(rng.randint(0, k, size=(n, k)), device=device)
        calls = {}
        for name, module in (("this", gather), ("other", other)):
            calls[f"rows {name}"] = lambda m=module: m.gather_rows(x, idx)
            calls[f"lanes {name}"] = lambda m=module: m.gather_lanes(t, li)
        calls["rows library"] = lambda: x[idx]
        calls["lanes library"] = lambda: torch.gather(t, 1, li)
        if k == 16:
            part = torch.as_tensor(rng.randn(n, k, 5), dtype=torch.float32,
                                   device=device)
            rev = torch.as_tensor(rng.randint(0, k, size=(n, k)),
                                  device=device)
            for name, module in (("this", gather), ("other", other)):
                calls[f"rev {name}"] = \
                    lambda m=module: m.rev_gather(part, idx, rev)
            calls["rev library"] = lambda: part[idx, rev]
            for name, module in (("this", trio), ("other", others["trio"])):
                calls[f"trio {name}"] = lambda m=module: m.trio_partials(
                    pot, d3, valid3, False)
        for name, fn in calls.items():
            kind = name.split()[0]
            # the trio has no library call: both checkouts' kernels agree
            got, ref = fn(), calls[f"{kind} this" if kind == "trio"
                                   else f"{kind} library"]()
            if kind == "trio":
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
            else:
                same = torch.equal(got, ref)
            if not same:
                raise AssertionError(f"{name} differs from its reference")
        names = list(calls)
        times = {name: [] for name in names}
        for r in range(rounds):
            for name in names if r % 2 == 0 else names[::-1]:
                times[name].append(host_us(calls[name]))
        out[f"{n} x {k}"] = dict(summarize(times), rounds_us=times)
    return out


def card() -> str:
    """nvidia-smi's "name, power limit" of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(against: str, out_dir: str = None, rounds: int = ROUNDS) -> dict:
    """``measure`` against the checkout at ``against``; writes
    ``gather_host.json`` and prints a line a shape."""
    artifact = dict(card=card(),
                    against=os.path.relpath(os.path.abspath(against), ROOT),
                    length=LENGTH, repeats=REPEATS, rounds=rounds,
                    shapes=measure(against, rounds))
    out_dir = out_dir or os.path.join(ROOT, "benchmarks_data",
                                      "artifacts_torch")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "gather_host.json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    for shape, record in artifact["shapes"].items():
        print(f"host us per eager call, {shape}, medians of {rounds} rounds: "
              + ", ".join(f"{name} {us:.2f}"
                          for name, us in record["median_us"].items())
              + "; this less other: " + ", ".join(
                  f"{kind} {q['median']:+.2f} ({q['q1']:+.2f} .. "
                  f"{q['q3']:+.2f})"
                  for kind, q in record["this_less_other_us"].items())
              + f"; card: {artifact['card']}")
    print(f"wrote {path}")
    return artifact


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", required=True,
                        help="the other checkout's root")
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--rounds", type=int, default=ROUNDS)
    args = parser.parse_args()
    main(args.against, args.out_dir, args.rounds)
