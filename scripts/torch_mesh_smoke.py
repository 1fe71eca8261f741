#!/usr/bin/env python
"""Mesh-daemon smoke of the PyTorch port: both halves run every time.

The port's twin of ``scripts/mesh_smoke.py``.

1. **mesh == flat digest gate** (in process, no C++ needed): the same
   packed request stream through a flat and a 2-way mesh ``TickRunner`` of
   the port's ``runtime/solverd.py`` must produce byte-identical replies
   and equal mirror and device audit digests every tick -- and with
   ``JG_SOLVER_MESH`` unset the resolved service must be the flat path
   (``service.mesh is None``).  The mesh's two shards are virtual shards of
   ``cuda:0`` (``parallel/virtual_mesh.virtual_devices``), or of the CPU
   under ``--cpu``.
2. **live fleet through a mesh daemon** (skipped without the C++ runtime):
   busd + the C++ centralized manager ``--solver tpu`` + the port's daemon
   with ``--mesh 2``, on virtual shards of the card
   (``JG_SOLVER_MESH_VIRTUAL=1``), or ``--cpu``; every dispatched task must
   complete, and the daemon's log must show the mesh banner.

Exit 0 = both halves green (or the live half explicitly SKIPPED).  The card
unless ``--cpu``; without CUDA and without ``--cpu`` it exits nonzero.

Usage: python scripts/torch_mesh_smoke.py [--log-dir DIR] [--cpu]
(the logs go to DIR, by default under the temporary directory.)
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402


def digest_gate(device="cuda", log=print) -> list:
    """The flat and the 2-way mesh runner on one stream; returns each
    tick's record (seq, reply bytes, mirror and device digests), equal on
    both.  Raises AssertionError where they differ."""
    from p2p_distributed_tswap_tpu_torch.core.grid import Grid
    from p2p_distributed_tswap_tpu_torch.obs import audit as au
    from p2p_distributed_tswap_tpu_torch.parallel.solver_mesh import (
        SolverMesh, mesh_spec_from_env)
    from p2p_distributed_tswap_tpu_torch.parallel.virtual_mesh import (
        virtual_devices)
    from p2p_distributed_tswap_tpu_torch.runtime import plan_codec as pc
    from p2p_distributed_tswap_tpu_torch.runtime.solverd import (PlanService,
                                                                 TickRunner)

    leaked = os.environ.get("JG_SOLVER_MESH")
    assert not leaked, \
        f"JG_SOLVER_MESH={leaked!r} leaked into the smoke env"
    # the kill-switch pin: an unset env resolves to NO mesh
    assert mesh_spec_from_env(leaked) is None
    grid = Grid.from_ascii("\n".join(["." * 16] * 16) + "\n")
    flat_svc = PlanService(grid, capacity_min=4, device=device)
    assert flat_svc.mesh is None  # unset env = the flat path, pinned
    flat_svc.defer_fields = False
    mesh_svc = PlanService(grid, capacity_min=4, mesh=SolverMesh(
        2, devices=virtual_devices(2, device)))
    mesh_svc.defer_fields = False
    flat, mesh = TickRunner(flat_svc, grid), TickRunner(mesh_svc, grid)
    enc_f = pc.PackedFleetEncoder(snapshot_every=4)
    enc_m = pc.PackedFleetEncoder(snapshot_every=4)

    rng = np.random.default_rng(3)
    free = np.flatnonzero(np.asarray(grid.free).reshape(-1)).astype(int)
    cells = rng.choice(free, size=12, replace=False)
    fleet = {f"p{k}": [int(cells[k]), int(cells[6 + k])] for k in range(6)}

    ticks = []
    for seq in range(1, 7):
        items = [(n, p, g) for n, (p, g) in sorted(fleet.items())]

        def req(enc):
            return {"type": "plan_request", "seq": seq,
                    "codec": pc.CODEC_NAME, "caps": [pc.CODEC_NAME],
                    "data": pc.encode_b64(enc.encode_tick(seq, items))}

        rf, rm = flat.handle(req(enc_f)), mesh.handle(req(enc_m))
        assert rm["data"] == rf["data"], f"wire diverged at seq {seq}"
        df = (au.lane_digest(*flat_svc.audit_views("mirror")),
              au.lane_digest(*flat_svc.audit_views("device")))
        dm = (au.lane_digest(*mesh_svc.audit_views("mirror")),
              au.lane_digest(*mesh_svc.audit_views("device")))
        assert df == dm, f"audit digests diverged at seq {seq}"
        ticks.append({"seq": seq, "data": rf["data"], "mirror": df[0],
                      "device": df[1]})
        rp = pc.decode_b64(rf["data"])
        for lane, c, g in zip(rp.idx, rp.pos, rp.goal):
            fleet[flat.packed.name_of(int(lane))] = [int(c), int(g)]
        fleet[f"p{int(rng.integers(6))}"][1] = int(rng.choice(free))
    per = mesh_svc.resident_shard_bytes()
    assert len(per) == 2, per
    log(f"mesh smoke: digest gate OK (6 ticks byte-identical, "
        f"per-shard bytes {sorted(per.values())}, shards on "
        f"{mesh_svc.mesh.lead}, virtual)")
    return ticks


def live_gate(log_dir: str, cpu: bool = False, log=print) -> dict:
    """Two agents through the C++ manager and a 2-way mesh daemon; returns
    the tasks done and the daemon's banner (or ``skipped``)."""
    if not (ROOT / "cpp" / "build" / "mapd_bus").exists() \
            and (shutil.which("cmake") is None
                 or shutil.which("ninja") is None):
        log("mesh smoke: live half SKIPPED (no C++ runtime)")
        return {"skipped": "no C++ runtime"}
    from p2p_distributed_tswap_tpu_torch.runtime import buspool
    from p2p_distributed_tswap_tpu_torch.runtime.fleet import Fleet

    mapf = Path(log_dir) / "t12.map.txt"
    mapf.parent.mkdir(parents=True, exist_ok=True)
    mapf.write_text("\n".join(["." * 12] * 12) + "\n")
    device_args = ["--cpu"] if cpu else []
    with Fleet("centralized", num_agents=2, port=buspool.free_port(),
               map_file=str(mapf), solver="tpu", log_dir=log_dir,
               env={"JG_SOLVER_MESH_VIRTUAL": "1"},
               solverd_args=[*device_args, "--mesh", "2"]) as fleet:
        time.sleep(4)
        fleet.command("tasks 2")
        deadline = time.monotonic() + 90
        done = 0
        while time.monotonic() < deadline:
            done = sum(f.read_text(errors="ignore").count("DONE")
                       for f in Path(log_dir).glob("agent_*.log"))
            if done >= 2:
                break
            time.sleep(1)
        fleet.quit()
    solverd_log = (Path(log_dir) / "solverd.log").read_text(
        errors="ignore")
    banner = [x for x in solverd_log.splitlines() if "solverd up" in x]
    assert "mesh=2x1" in solverd_log, "solverd did not build the mesh"
    assert done >= 2, "live mesh fleet did not complete its tasks"
    log("mesh smoke: live half OK (2 tasks completed through a "
        "2-way mesh solverd)")
    return {"done": done, "banner": banner[0] if banner else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", default=os.path.join(
        tempfile.gettempdir(), "torch_mesh_smoke_logs"))
    ap.add_argument("--cpu", action="store_true",
                    help="run the meshes on the CPU (the default is the "
                         "card)")
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_mesh_smoke: CUDA is not available; pass --cpu to "
                 "run on the CPU")
    if args.cpu:  # many small ops: intra-op threads cost more than they give
        torch.set_num_threads(1)
    log = lambda m: print(m, flush=True)  # noqa: E731
    digest_gate("cpu" if args.cpu else "cuda", log=log)
    live_gate(args.log_dir, cpu=args.cpu, log=log)
    print("mesh smoke OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
