"""
What the measurement scripts share: the device (the card unless asked
for the CPU, as ``MDSystem``), the chain length, CUDA-graph and eager
timing of a chained body, the card's description, the commit and the
artifact directory.

Device times come from CUDA graphs: ``SCAN_LEN`` bodies chained (each
takes the previous one's output, as the JAX scripts' ``lax.scan``
chains them) are captured in one graph and replayed between CUDA
events, so that no host cost enters them.  Host times run the same
chain eagerly, ended by a synchronize.  A time is never divided by a
chain length it was not measured over.
"""

import json
import os
import subprocess
import time

import torch

from uf3_tpu_torch.forcefield.md import _resolve_device as resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARTIFACTS = os.path.join(REPO, "benchmarks_data", "artifacts_torch")
SCAN_LEN = 30


def chain(fn, x, length: int):
    """fn applied ``length`` times, each to the previous output."""
    for _ in range(length):
        x = fn(x)
    return x


def graph_chain_ms(fn, x0, length: int = SCAN_LEN, generators=(),
                   replays: int = 10) -> float:
    """Mean device ms per body: ``length`` chained bodies captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so that
    the host's per-call cost (Python, ctypes, allocation) does not hide
    a body shorter than it.  ``generators`` are the torch generators the
    body draws from, registered with the graph so that every replay
    draws anew.  A body that ignores its input times one call
    ``length`` times."""
    chain(fn, x0, length)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain(fn, x0, length)  # warm the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        chain(fn, x0, length)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * length)


def graph_ms(fn, repeats: int = SCAN_LEN, replays: int = 10) -> float:
    """Mean device ms of one call fn(): ``repeats`` calls in one CUDA
    graph (``graph_chain_ms`` on a body that ignores its input)."""
    def body(x):
        fn()
        return x

    return graph_chain_ms(body, None, repeats, replays=replays)


def host_chain_ms(fn, x0, length: int = SCAN_LEN, repeats: int = 3) -> float:
    """Host ms per body: ``length`` chained bodies run eagerly, ended by
    a synchronize on a card; the best of ``repeats`` after one warm
    chain."""
    def sync():
        if x0.is_cuda:
            torch.cuda.synchronize(x0.device)

    chain(fn, x0, length)
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        chain(fn, x0, length)
        sync()
        best = min(best, (time.perf_counter() - t0) / length)
    return 1e3 * best


def card(device: torch.device):
    """(name, "name, power limit" from nvidia-smi) of a card; (None,
    None) for the CPU."""
    if device.type != "cuda":
        return None, None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return (torch.cuda.get_device_name(device),
            out.stdout.strip().splitlines()[device.index or 0])


def commit() -> str:
    """The checkout's short commit, or "unknown" outside a git
    checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=60)
    except OSError:
        return "unknown"
    return out.stdout.strip() or "unknown"


def header(device: torch.device, commit_tag: str = None) -> dict:
    """The artifact's description of the run: platform, card, commit,
    time."""
    name, card_line = card(device)
    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "device": name, "card": card_line,
            "commit": commit_tag or commit(),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}


def write_artifact(artifact: dict, out_dir: str, name: str) -> str:
    """Write ``artifact`` as JSON to ``out_dir``/``name``; returns the
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    return path
