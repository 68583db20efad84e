"""
Melting-point bracket of the fitted 2+3-body W model on the card: a
two-phase coexistence trial at each temperature, the trials appended to
one artifact, and the bracket they give.  Port of
``benchmarks/melting_run.py``'s ``main``.

Each trial is ``uf3_tpu_torch.examples.melting_point.run_trial`` (the
reference's ``run_trial``): bcc W ``--reps`` (48 x 18 x 18 = 31,104
atoms by default), equilibrated at T, half of it melted with the other
half pinned, re-cooled, then released under NPT for up to ``--obs``
steps; its verdict is "grew" (T below the model's melting point),
"shrank" (above), "flat" or "prep_failed".  The trials already in the
artifact stay, each new one is appended with the card and commit it ran
on, and the file is written after every trial.  The bracket is
[max(grew), min(shrank)] where every trial that grew ran cooler than
every trial that shrank.  The reference writes it whenever both kinds
exist (``benchmarks/melting_run.py:283-285``), reversed where a cooler
trial shrank and a hotter one grew; the port then writes none.

    python -m uf3_tpu_torch.benchmarks.melting_run [T ...] [--reps X Y Z]
        [--obs N] [--prep-scale S] [--out PATH] [--device cpu]

(default 2,500 and 3,500 K, 48,000 release steps) writes
``benchmarks_data/artifacts_torch/melting_point.json``.
"""

import argparse
import json
import os

import torch

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.examples import melting_point

OUT = os.path.join(common.ARTIFACTS, "melting_point.json")
PROTOCOL = "two-phase coexistence (melting_uf.in analogue)"


def bracket(trials):
    """[max(grew), min(shrank)] of the trials' temperatures, or None
    where either kind is missing or a trial that grew ran at least as
    hot as one that shrank."""
    grew = [t["T"] for t in trials if t["verdict"] == "grew"]
    shrank = [t["T"] for t in trials if t["verdict"] == "shrank"]
    if grew and shrank and max(grew) < min(shrank):
        return [max(grew), min(shrank)]
    return None


def main(argv=None, keep: dict = None) -> dict:
    """Run the trials of the command line and write the artifact after
    each; returns it.  ``keep``, where given, receives the last trial's
    system and state."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("temps", nargs="*", type=float,
                        default=[2500.0, 3500.0])
    parser.add_argument("--reps", nargs=3, type=int, default=[48, 18, 18])
    parser.add_argument("--obs", type=int, default=48000)
    parser.add_argument("--prep-scale", type=float, default=1.0)
    parser.add_argument("--out", default=OUT)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--commit", default=None,
                        help="the trials' commit (default: git's short "
                             "commit)")
    args = parser.parse_args(argv)
    device = common.resolve_device(args.device)
    name, card = common.card(device)
    trials = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            trials = json.load(f).get("trials", [])
    results = {"protocol": PROTOCOL, "platform": common.platform(device),
               "trials": trials}
    for t in args.temps:
        print(f"=== trial T = {t:.0f} K ===", flush=True)
        log = melting_point.run_trial(
            common.MODEL, t, tuple(args.reps), args.obs,
            prep_scale=args.prep_scale, dtype=torch.float32, device=device,
            keep=keep)
        log.update(card=card or name or device.type,
                   commit=args.commit or common.commit())
        trials.append(log)
        results.pop("melting_point_bracket_K", None)
        found = bracket(trials)
        if found is not None:
            results["melting_point_bracket_K"] = found
        common.write_artifact(common.stamp(results, device, args.commit),
                              os.path.dirname(args.out) or ".",
                              os.path.basename(args.out))
    print(json.dumps({k: v for k, v in results.items() if k != "trials"}))
    return results


if __name__ == "__main__":
    main()
