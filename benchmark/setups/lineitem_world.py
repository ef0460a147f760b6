"""Set-up of a TPC-H lineitem table held resident over a world of
processes, one card each: the deployment of a cluster of nodes with one
card a node, as one ``torch.distributed`` world (NCCL on cards, gloo on
the CPU).

The run's own process is rank 0, on the device the harness gives it.  It
starts ranks 1 to ``world - 1`` as child processes (this file run as a
script, rank ``r`` on card ``r``), and every rank joins the world
through the program's ``distributed_init`` at ``tcp://localhost:<a free
port>`` with a timeout on every collective.  Lineitem's slices of
``orders_per_slice`` orders go round robin over the ranks, slice ``b`` to
rank ``b mod world``: each rank generates its own slices from the seed
(``benchmark/reference/lineitem.py``, in threads) and makes them resident
with the program's per-process loader (``load_sharded_resident``, tile
``tile``), one shard a rank.

Rank 0 then drives the others: :meth:`Data.send` writes an operation's
name and parameters to every child's standard input, one JSON line, and
each child runs ``on_rank(table, params)`` of that operation's module
(``benchmark/ops/<operation>.py``), the same call rank 0 makes.  A child
exits at a stop line, at the end of its input, or when rank 0's process
is gone (it watches its parent's pid); :meth:`Data.release` stops them
and leaves the world.

Configuration keys read: ``scale``, ``orders_per_slice``, ``columns``,
``tile``, ``world`` (processes), ``orders`` (the table's orders, default
the scale factor's: tests make small tables so) and ``storage``:
``"resident"`` builds the world, ``"host"`` (the control's) only keeps
the configuration and the seed.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the program's entries of a world, imported before any process starts:
# a program without them fails here, at once
from strawboat_tpu_torch.parallel import (  # noqa: E402,F401
    distributed_init,
    load_sharded_resident,
    make_mesh,
    sharded_keyed_aggregate,
)

from benchmark.lib import manifest as mf  # noqa: E402
from benchmark.reference import lineitem as li_lib  # noqa: E402
from benchmark.reference.q15 import slices_of  # noqa: E402

TIMEOUT_S = 120.0  # the world's limit on joining and on one collective
STOP_WAIT_S = 60.0  # a child's time to leave once stopped
AXIS = "shards"


def rank_slices(cfg: dict, rank: int, world: int) -> List[int]:
    """The slices rank ``rank`` holds: slice ``b`` lives on rank ``b mod
    world``."""
    return slices_of(cfg)[rank::world]


def generate(cfg: dict, seed: int, rank: int, world: int):
    """Rank ``rank``'s rows of the configured columns, as numpy columns."""
    li = li_lib.generate_lineitem(seed, float(cfg["scale"]), int(cfg["orders_per_slice"]),
                                  rank_slices(cfg, rank, world), cfg["columns"])
    return li.columns(cfg["columns"])


def join_and_load(cfg: dict, cols, addr: str, rank: int, device: str):
    """Join the world and make this rank's columns resident: the sharded
    table (one shard a rank)."""
    world = int(cfg["world"])
    distributed_init(addr, world, rank, device, timeout=TIMEOUT_S)
    mesh = make_mesh(world, device)
    return load_sharded_resident([cols], mesh, AXIS, tile=int(cfg["tile"]))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@dataclass
class Data:
    cfg: dict
    seed: int
    srt: Optional[Any] = None  # this rank's view of the sharded resident table
    children: List[subprocess.Popen] = field(default_factory=list)
    seconds: Dict[str, float] = field(default_factory=dict)  # set-up by part
    stopping: bool = False

    def send(self, op: str, params: dict) -> None:
        """Every child runs ``op`` on ``params`` next (rank 0 makes the
        same call itself); a child that is gone fails the operation at
        once instead of leaving the world waiting."""
        line = (json.dumps({"op": op, "params": params}) + "\n").encode()
        for c in self.children:
            if c.poll() is not None:
                raise RuntimeError(f"rank process {c.pid} exited with {c.returncode}")
            c.stdin.write(line)
            c.stdin.flush()

    def release(self) -> None:
        """Stop the children and leave the world with them (every rank
        destroys its process group at once: NCCL's teardown waits for the
        peers), then free the table; the configuration and seed stay for
        the check."""
        import torch

        t0 = time.perf_counter()
        self.stopping = True
        for c in self.children:
            try:
                c.stdin.write(b'{"stop": true}\n')
                c.stdin.close()
            except OSError:
                pass
        self.srt = None
        if torch.distributed.is_initialized():
            leave = threading.Thread(target=torch.distributed.destroy_process_group, daemon=True)
            leave.start()
            leave.join(STOP_WAIT_S)
            if leave.is_alive():
                print(f"rank 0 still leaving the world after {STOP_WAIT_S} s", file=sys.stderr)
        for c in self.children:
            try:
                c.wait(STOP_WAIT_S)
            except subprocess.TimeoutExpired:
                c.kill()
                c.wait()
        print(f"world of {len(self.children) + 1} left in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr, flush=True)
        self.children = []


def build(cfg: dict, seed: int, device) -> Data:
    data = Data(cfg, seed)
    if cfg["storage"] == "host":
        return data
    if cfg["storage"] != "resident":
        raise ValueError(f"storage {cfg['storage']!r} (resident or host)")
    world = int(cfg["world"])
    addr = f"localhost:{_free_port()}"
    t0 = time.perf_counter()
    for r in range(1, world):
        c = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r)],
                             stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, cwd=ROOT)
        data.children.append(c)
        c.stdin.write((json.dumps({"cfg": cfg, "seed": seed, "addr": addr,
                                   "device": device.type}) + "\n").encode())
        c.stdin.flush()
    data.seconds["start_ranks"] = time.perf_counter() - t0
    threading.Thread(target=_watch_children, args=(data,), daemon=True).start()
    try:
        t0 = time.perf_counter()
        cols = generate(cfg, seed, 0, world)
        data.seconds["generate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        data.srt = join_and_load(cfg, cols, addr, 0, str(device))
        data.seconds["join_and_load"] = time.perf_counter() - t0
    except BaseException:
        data.release()
        raise
    return data


def _watch_children(data: Data) -> None:
    """End the run at once when a child exits before it is stopped: the
    world cannot answer without it, and rank 0 would wait in a collective
    until the timeout."""
    while not data.stopping:
        for c in data.children:
            if c.poll() is not None and not data.stopping:
                print(f"rank process {c.pid} exited with {c.returncode}; ending the run",
                      file=sys.stderr, flush=True)
                os._exit(1)
        time.sleep(0.5)


def _watch_parent(parent: int) -> None:
    """End this process once its parent (rank 0) is gone, even inside a
    collective."""
    while True:
        time.sleep(0.5)
        if os.getppid() != parent:
            os._exit(3)


def child_main(rank: int) -> None:
    """Rank ``rank``: its set-up line, then operations until a stop line
    or the end of the input; then the process ends."""
    parent = os.getppid()
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    import torch

    first = json.loads(sys.stdin.buffer.readline())
    cfg, world = first["cfg"], int(first["cfg"]["world"])
    device = f"cuda:{rank}" if first["device"] == "cuda" else "cpu"
    if first["device"] == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cols = generate(cfg, int(first["seed"]), rank, world)
    srt = join_and_load(cfg, cols, first["addr"], rank, device)
    del cols
    try:
        for line in sys.stdin.buffer:
            msg = json.loads(line)
            if msg.get("stop"):
                break
            try:
                mf.plugin("ops", msg["op"], ROOT).on_rank(srt, msg["params"])
            except Exception:  # raised alike on every rank: rank 0 counts it
                traceback.print_exc()
    finally:
        del srt
        torch.distributed.destroy_process_group()  # with rank 0's, at the stop line
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "--rank":
        sys.exit("usage: lineitem_world.py --rank <r>  (started by build(), its set-up on stdin)")
    child_main(int(sys.argv[2]))
