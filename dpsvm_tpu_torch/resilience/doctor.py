"""``doctor``: is the machine sane before a long run? (port of
``dpsvm_tpu/resilience/doctor.py``)

A preflight of what a training run depends on, each part with a bounded
wait, ending in one ``DOCTOR`` line and an exit code:

1. **Backend** (exit 3): the card answers (``device="cuda"``), or the run
   is asked for the CPU. The topology line names the card(s), and the
   roofline line prints the peak table ``report`` divides by.
2. **Collective probe** (exit 4: more ranks than devices; exit 5: hung,
   failed or wrong): an all-reduce of ones over the requested ranks in a
   worker thread with a deadline, NCCL on the card (a world of one), gloo
   on the CPU; more than one rank runs in local ranks
   (``multihost.launch_local``). ``DPSVM_FAULT_PREFLIGHT_WEDGE_S=t`` makes
   it hang t seconds first.
3. **Checkpoint health** (exit 6; free disk exit 8): directory
   writability, the rotation set scanned as a resume would scan it, the
   newest intact slot's mesh and iteration (another mesh is a pending
   re-shard, not an error).
4. **Data health** (``data_path``; exit 7 integrity, 8 disk): manifest,
   live-log state, CRC spot-check, free disk, a timed one-shard read.
5. **Host group** (``coordinator`` / ``hosts_dir``; exit 9): TCP reach of
   the coordinator and heartbeat freshness from the group supervisor's
   directory (``resilience/hostgroup.py``); the doctor never joins a
   group.
6. **Serving** (``serving_url``): a live server's tenant budget, model
   cache and front door, reported only.

After the roofline line, ``tuned:`` lines say which tuned-knob profile
entry train and serve would consult on the doctor's device
(``tuning/profile.doctor_lines``), or why none applies.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Callable, List, Optional, Tuple


def _probe_rank(rank: int, device: str) -> float:
    """One local rank's share of the probe: all-reduce a one."""
    import torch
    import torch.distributed as dist
    t = torch.ones(1, device=device)
    dist.all_reduce(t)
    return float(t.item())


def _collective_probe(shards: int, device: str, timeout_s: float
                      ) -> Tuple[bool, str]:
    """All-reduce of ones over ``shards`` ranks with a deadline: (ok,
    detail, the detail ending in the reduction's milliseconds). Runs in a
    daemon worker so a hung collective cannot hold the doctor past its
    budget."""
    from dpsvm_tpu_torch.resilience import faultinject
    result: dict = {}
    abandoned = threading.Event()
    plan = faultinject.current()
    wedge = float(plan.preflight_wedge_s) if plan is not None else 0.0

    def work():
        try:
            if wedge:
                time.sleep(wedge)        # the injected dead device
            if abandoned.is_set():
                return
            import torch
            import torch.distributed as dist

            from dpsvm_tpu_torch.parallel import multihost
            dev = torch.device(device)
            if shards > 1:
                t0 = time.perf_counter()
                got = multihost.launch_local(
                    shards, _probe_rank, (str(dev),), device=dev.type,
                    timeout_s=timeout_s, run_timeout_s=timeout_s)
                result["ms"] = (time.perf_counter() - t0) * 1e3
                result["got"] = got[0]
                return
            own = not dist.is_initialized()
            tmp = tempfile.mkdtemp(prefix="dpsvm_doctor_")
            if own:
                dist.init_process_group(
                    "nccl" if dev.type == "cuda" else "gloo",
                    store=dist.FileStore(os.path.join(tmp, "store"), 1),
                    world_size=1, rank=0)
            try:
                t = torch.ones(1, device=dev)
                dist.all_reduce(t)            # the first call sets up
                t.fill_(1.0)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                dist.all_reduce(t)
                result["got"] = float(t.item())
                result["ms"] = (time.perf_counter() - t0) * 1e3
            finally:
                if own:
                    dist.destroy_process_group()
                for name in os.listdir(tmp):
                    os.unlink(os.path.join(tmp, name))
                os.rmdir(tmp)
        except Exception as e:
            result["err"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=work, daemon=True,
                         name="dpsvm-doctor-collective")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        abandoned.set()
        return False, (f"collective probe TIMED OUT after {timeout_s:g}s "
                       f"on {shards} rank(s) — suspect a hung "
                       "interconnect or wedged device")
    if "err" in result:
        return False, f"collective probe failed: {result['err']}"
    want = float(shards)
    if result.get("got") != want:
        return False, (f"collective probe returned {result.get('got')} "
                       f"!= {want} — a device is computing wrong "
                       "answers")
    return True, (f"all_reduce over {shards} rank"
                  f"{'s' if shards != 1 else ''} on {device} OK "
                  f"(= {result['got']:g}) in {result['ms']:.3f} ms")


def _checkpoint_probe(path: str, shards: int) -> Tuple[bool, List[str]]:
    """Writability + newest-slot integrity of a checkpoint path."""
    from dpsvm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                            newest_intact_checkpoint)

    lines: List[str] = []
    directory = os.path.dirname(os.path.abspath(path)) or "."
    try:
        os.makedirs(directory, exist_ok=True)
        fd, probe = tempfile.mkstemp(dir=directory,
                                     suffix=".doctor-probe")
        os.close(fd)
        os.unlink(probe)
        lines.append(f"checkpoint dir writable: {directory}")
    except OSError as e:
        lines.append(f"checkpoint dir NOT writable: {directory} ({e})")
        return False, lines
    if not os.path.exists(path):
        lines.append(f"no checkpoint yet at {path} (a fresh run "
                     "starts from scratch)")
        return True, lines
    best, skipped = newest_intact_checkpoint(path)
    if skipped:
        lines.append(f"corrupt/unreadable slot(s) skipped: {skipped}")
    if best is None:
        lines.append(f"NO intact checkpoint slot at {path} — a "
                     "restart cannot resume")
        return False, lines
    ck = load_checkpoint(best)
    bad = ck.verify_shard_crcs()
    if bad:
        lines.append(f"newest intact slot {best} has damaged shard "
                     f"region(s) {bad}")
        return False, lines
    note = ""
    if ck.needs_reshard(shards):
        note = (f" — saved on a {ck.mesh_desc()}, this mesh is "
                f"{shards}: resume will RE-SHARD (not an error)")
    lines.append(f"newest intact slot: {best} (iter {ck.n_iter}, "
                 f"({ck.n}, {ck.d}) problem, {ck.shards}-shard "
                 f"manifest){note}")
    return True, lines


#: free-space floor for the disk probes: below this a checkpoint
#: rotation (or the next shard write) is one bad day from ENOSPC.
MIN_FREE_BYTES = 64 * 1024 * 1024


def _free_disk_probe(directory: str, need_bytes: int
                     ) -> Tuple[bool, str]:
    """Free space on ``directory``'s filesystem vs what the caller is
    about to write (floored at MIN_FREE_BYTES)."""
    try:
        st = os.statvfs(directory)
    except OSError as e:
        return False, f"cannot stat filesystem of {directory}: {e}"
    free = st.f_bavail * st.f_frsize
    need = max(int(need_bytes), MIN_FREE_BYTES)
    mb = 1024.0 * 1024.0
    if free < need:
        return False, (f"{directory}: only {free / mb:.0f} MiB free "
                       f"(< {need / mb:.0f} MiB needed) — the next "
                       "write will ENOSPC")
    return True, f"{directory}: {free / mb:,.0f} MiB free"


def _data_probe(path: str, out: Callable[[str], None]
                ) -> Tuple[bool, int]:
    """Shard-dataset health: manifest + CRC spot-check + free disk +
    one-shard timed read, plus the live-log probes (docs/DATA.md
    "Live shard logs") — manifest generation, a torn in-progress
    publish, and a conversion cursor ahead of the manifest each get a
    distinct one-line verdict under the existing exit-code scheme
    (7 = integrity, 8 = disk). Returns (ok, exit_code)."""
    import glob
    import json

    from dpsvm_tpu_torch.data.live import TornPublishError
    from dpsvm_tpu_torch.data.stream import (CURSOR_NAME, ShardedDataset,
                                       StreamError)

    # Live-log state probes run FIRST: a torn publish makes the
    # manifest unopenable, and the verdict must say "writer crashed
    # mid-publish", not "corrupt dataset". A .prev backup beside an
    # unreadable manifest is the torn-publish signature — a frozen
    # dataset with a rotted manifest has no backup and keeps the
    # ordinary corrupt-manifest verdict.
    from dpsvm_tpu_torch.data.live import (PREV_MANIFEST_NAME,
                                     read_manifest_checked)
    cursor_path = os.path.join(path, CURSOR_NAME)
    if os.path.isdir(path):
        try:
            read_manifest_checked(path)
        except TornPublishError as e:
            if os.path.exists(os.path.join(path, PREV_MANIFEST_NAME)):
                out(f"data: {e}")
                out("DOCTOR FAIL: in-progress (torn) publish — a "
                    "writer crashed mid-publish (or is mid-write on a "
                    "non-atomic filesystem); readers hold their last "
                    "admitted view, the restarted writer repairs from "
                    f"{PREV_MANIFEST_NAME}")
                return False, 7
        except StreamError:
            pass                # open() below owns the verdict
    try:
        ds = ShardedDataset.open(path)
    except (FileNotFoundError, StreamError) as e:
        out(f"data: {e}")
        out(f"DOCTOR FAIL: {e}")
        return False, 7
    if os.path.exists(cursor_path):
        try:
            with open(cursor_path) as fh:
                rows_done = int(json.load(fh).get("rows_done", 0))
        except (OSError, ValueError):
            rows_done = -1
        if rows_done > ds.n or rows_done < 0:
            out(f"data: conversion cursor claims {rows_done} row(s) "
                f"done but the manifest holds {ds.n}")
            out("DOCTOR FAIL: cursor ahead of the manifest — a "
                "conversion wrote past the published dataset (foreign "
                "cursor, or a manifest rolled back under it); delete "
                f"{CURSOR_NAME} only after confirming the shards")
            return False, 7
        out(f"data: stale conversion cursor present ({rows_done} "
            f"rows done <= manifest n={ds.n}; harmless leftover)")
    tmps = glob.glob(os.path.join(path, "manifest.json.tmp*"))
    if tmps:
        out(f"data: {len(tmps)} manifest tmp file(s) present — a "
            "publish may be in flight (or a writer died pre-rename); "
            "harmless to readers")
    gen = int(ds.manifest.get("generation", 0))
    out(f"data: {path}: {ds.n} rows x {ds.d} features in "
        f"{ds.n_shards} shard(s) of {ds.rows_per_shard} "
        f"({ds.manifest.get('label_dtype')} labels, "
        f"log generation {gen}"
        + (", live-append manifest" if "manifest_crc" in ds.manifest
           else ", frozen conversion") + ")")
    ok, detail = _free_disk_probe(path, MIN_FREE_BYTES)
    out(f"data: disk: {detail}")
    if not ok:
        out(f"DOCTOR FAIL: {detail}")
        return False, 8
    problems = ds.verify(spot=3)
    if problems:
        for p in problems:
            out(f"data: INTEGRITY: {p}")
        out(f"DOCTOR FAIL: {problems[0]} — a training run would "
            "raise (or quarantine) here")
        return False, 7
    import time
    t0 = time.perf_counter()
    x, _y = ds.read_shard(0)
    dt = max(time.perf_counter() - t0, 1e-9)
    mb = x.nbytes / (1024.0 * 1024.0)
    out(f"data: timed read: shard 0 ({mb:.1f} MiB) in {dt * 1e3:.1f} "
        f"ms ({mb / dt:,.0f} MB/s) — CRC spot-check OK on "
        f"{min(3, ds.n_shards)} shard(s)")
    return True, 0


def _serving_tenant_probe(url: str, out: Callable[[str], None]) -> None:
    """Reporting-only probe of a live serve process's tenant label
    budget (docs/OBSERVABILITY.md "Per-tenant attribution"): live
    series vs budget, evictions, overflow folded into 'other' — with a
    WARNING near saturation (>= 80% of budget), since a saturated
    budget means NEW tenants stop getting their own cost rows. Never
    changes the doctor verdict: a down server is not a broken mesh."""
    import json
    import urllib.error
    import urllib.request

    full = url.rstrip("/")
    if not full.endswith("/metricsz"):
        full += "/metricsz"
    try:
        with urllib.request.urlopen(full, timeout=10) as r:
            obj = json.loads(r.read())
    except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
        out(f"serving: UNREACHABLE ({e}) — reporting only, not a "
            "doctor failure")
        return
    tn = obj.get("tenants") if isinstance(obj, dict) else None
    if not isinstance(tn, dict):
        out("serving: no tenant block in /metricsz (pre-attribution "
            "server, or not a `dpsvm serve` endpoint)")
        return
    budget = int(tn.get("budget") or 0)
    live = int(tn.get("live") or 0)
    out(f"serving: tenant labels: {live}/{budget} budget slots live, "
        f"{int(tn.get('evictions') or 0)} evictions, "
        f"{int(tn.get('overflow') or 0)} requests folded into "
        "'other'")
    if budget and live >= 0.8 * budget:
        out(f"serving: WARNING tenant label budget near saturation "
            f"({live}/{budget} live) — new tenants will fold into "
            "'other'; raise `serve --tenant-budget` if per-tenant "
            "attribution matters for the tail")
    # Model-cache saturation (docs/SERVING.md "Model fleet") — same
    # reporting-only contract: a thrashing cache is a capacity-planning
    # fact, not a broken mesh.
    mc = obj.get("model_cache") if isinstance(obj, dict) else None
    if isinstance(mc, dict):
        mbudget = int(mc.get("budget") or 0)
        resident = int(mc.get("resident") or 0)
        faults = int(mc.get("faults") or 0)
        evictions = int(mc.get("evictions") or 0)
        transients = int(mc.get("transients") or 0)
        out(f"serving: model cache: {resident}/{mbudget} residents, "
            f"{faults} faults, {evictions} evictions, "
            f"{transients} transient serves, cold-start p99 "
            f"{float(mc.get('cold_start_p99_ms') or 0.0):.1f} ms, "
            f"~{int(mc.get('resident_bytes_est') or 0) // (1 << 20)} "
            "MiB resident")
        if mbudget and resident >= 0.8 * mbudget:
            out(f"serving: WARNING model cache near saturation "
                f"({resident}/{mbudget} resident) — cold models serve "
                "transiently until a second touch evicts the LRU; "
                "raise `serve --model-cache-budget` if the working "
                "set outgrew the budget (watch the model-cache-thrash "
                "rule)")
    # Front-door transport (docs/SERVING.md "Front door") — same
    # reporting-only contract: connection-cap pressure and queue-lane
    # depth are capacity facts, not a broken mesh.
    fd = obj.get("front_door") if isinstance(obj, dict) else None
    if isinstance(fd, dict):
        kind = fd.get("kind", "threaded")
        if kind != "async":
            out("serving: front end: threaded (thread-per-connection; "
                "`serve --front-end async` holds 10k+ connections on "
                "one event loop)")
        else:
            open_c = int(fd.get("open_connections") or 0)
            max_c = int(fd.get("max_connections") or 0)
            out(f"serving: front end: async ({open_c}/{max_c} "
                "connections open, "
                f"{int(fd.get('connections_rejected') or 0)} rejected "
                f"at the cap, {int(fd.get('inflight_rows') or 0)} "
                "rows in flight)")
            fq = fd.get("fair_queue") or {}
            lanes = fq.get("lanes") or {}
            if lanes:
                depth = ", ".join(
                    f"{t}: {int(v.get('rows') or 0)} rows (w="
                    f"{v.get('weight')})"
                    for t, v in sorted(lanes.items()))
                out(f"serving: fair-queue lanes: {depth}; "
                    f"{int(fq.get('rows_queued') or 0)} rows queued "
                    f"of {int(fq.get('lane_capacity_rows') or 0)} "
                    "per-lane capacity")
            if max_c and open_c >= 0.8 * max_c:
                out(f"serving: WARNING open connections near the cap "
                    f"({open_c}/{max_c}) — new connections will get "
                    "an immediate 503; raise `serve "
                    "--max-connections` if this is organic load")


def _hostgroup_probe(coordinator: Optional[str],
                     hosts_dir: Optional[str],
                     num_hosts: int, max_age_s: float,
                     timeout_s: float,
                     out: Callable[[str], None]) -> Tuple[bool, str]:
    """Multi-host preflight (docs/DISTRIBUTED.md "Multi-host").
    Reporting-only and collective-free by design: the coordinator
    check is a pure TCP connect with a deadline (usable from a process
    that will later join the group), and group liveness is read from the
    heartbeat files the supervisor itself watches. The cross-host
    psum agreement check runs ONLY when this process is already
    inside an initialized group — the doctor never forms one.
    Returns (ok, reason-if-degraded)."""
    from dpsvm_tpu_torch.parallel import multihost
    from dpsvm_tpu_torch.resilience import hostgroup

    degraded: List[str] = []
    if coordinator:
        why = multihost.coordinator_reachable(
            coordinator, timeout_s=min(timeout_s, 10.0))
        if why is None:
            out(f"hostgroup: coordinator {coordinator} reachable")
        else:
            out(f"hostgroup: {why}")
            degraded.append(why)
    if hosts_dir:
        beats = hostgroup.read_heartbeats(hosts_dir)
        ages = hostgroup.heartbeat_ages(hosts_dir)
        expected = (set(range(int(num_hosts))) if num_hosts
                    else set(beats))
        if not beats:
            msg = f"no heartbeats in {hosts_dir}"
            out(f"hostgroup: {msg}")
            degraded.append(msg)
        for hid in sorted(expected | set(beats)):
            rec = beats.get(hid)
            if rec is None:
                msg = f"host {hid} has NO heartbeat (expected one)"
                out(f"hostgroup: {msg}")
                degraded.append(msg)
                continue
            age = ages.get(hid, float("inf"))
            stale = age > max_age_s
            # seq vs wall-clock disagreement (docs/OBSERVABILITY.md
            # "Fleet"): the heartbeat's own wall stamp `t` older than
            # the file mtime says by more than the staleness budget
            # means the writer's clock stepped BACKWARD mid-run — the
            # record is fresh (seq advanced, mtime young) but its
            # timestamp lies. A stalled host is the opposite shape:
            # old mtime AND old t, seq frozen.
            seq = rec.get("seq")
            clock_note = ""
            t_rec = rec.get("t")
            if isinstance(t_rec, (int, float)):
                try:
                    mtime = os.path.getmtime(
                        hostgroup.heartbeat_path(hosts_dir, hid))
                    drift = mtime - float(t_rec)
                    if not stale and drift > max_age_s:
                        clock_note = (f" — wall clock stepped back "
                                      f"{drift:.0f}s (seq {seq} is "
                                      "fresh; trust seq, not t)")
                except OSError:
                    pass
            out(f"hostgroup: host {hid}: beat {age:.1f}s ago, "
                f"iter {rec.get('n_iter')}, "
                f"seq {seq if seq is not None else '-'}, "
                f"generation {rec.get('generation')}, "
                f"pid {rec.get('pid')}"
                + (f" — STALE (> {max_age_s:g}s, seq frozen at "
                   f"{seq})" if stale else "")
                + clock_note)
            if stale:
                degraded.append(f"host {hid} heartbeat {age:.1f}s old "
                                f"(> {max_age_s:g}s)")
            elif clock_note:
                degraded.append(f"host {hid} wall clock stepped "
                                "backward (heartbeat t older than "
                                "file mtime)")
    if multihost.is_initialized():
        import numpy as np
        got = multihost.host_allgather(multihost.host_id())
        want = list(range(multihost.host_count()))
        if sorted(int(v) for v in np.asarray(got).ravel()) == want:
            out(f"hostgroup: cross-host allgather agrees "
                f"({multihost.host_count()} host(s))")
        else:
            msg = (f"cross-host allgather disagrees: {got!r} vs "
                   f"hosts {want}")
            out(f"hostgroup: {msg}")
            degraded.append(msg)
    else:
        out("hostgroup: not inside an initialized host group — "
            "cross-host collective check skipped (reporting-only: "
            "the doctor never initializes one)")
    return (not degraded,
            degraded[0] if degraded else "")


def run_doctor(shards: int = 0, checkpoint_path: Optional[str] = None,
               data_path: Optional[str] = None,
               timeout_s: float = 60.0,
               serving_url: Optional[str] = None,
               coordinator: Optional[str] = None,
               hosts_dir: Optional[str] = None,
               num_hosts: int = 0,
               heartbeat_max_age_s: float = 60.0,
               device: str = "cuda",
               out: Callable[[str], None] = print) -> int:
    """The whole preflight; returns the exit code (0 = sane). Prints its
    findings through ``out``, always ending with one DOCTOR line."""
    import torch

    from dpsvm_tpu_torch.observability import roofline
    from dpsvm_tpu_torch.parallel.multihost import topology

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            reason = "torch.cuda.is_available() is false"
            out(f"backend: UNREACHABLE ({reason})")
            out(f"DOCTOR FAIL: backend unreachable — {reason} (pass "
                "--device cpu to check the CPU)")
            return 3
        visible = torch.cuda.device_count()
        kinds = sorted({torch.cuda.get_device_name(i)
                        for i in range(visible)})
        from dpsvm_tpu_torch.solver.driver import power_limit
        topo = topology()
        out(f"backend: cuda ({visible} device(s), "
            f"process {topo.get('process_id')}/{topo.get('processes')}, "
            f"kinds {kinds}, power limit {power_limit()})")
        dev = torch.device("cuda", dev.index or 0)
    else:
        visible = 1
        kinds = ["cpu"]
        out("backend: cpu (1 device; gloo collectives)")
    for line in roofline.doctor_lines(kinds):
        out(f"roofline: {line}")
    # Which per-device knob profile train/serve would consult right now,
    # or exactly why none applies (missing, opted out, another device,
    # provenance-invalid).
    from dpsvm_tpu_torch.tuning import profile as tuned_profile
    for line in tuned_profile.doctor_lines(
            tuned_profile.current_device_kind(dev)):
        out(f"tuned: {line}")
    p = int(shards) or visible
    if p > visible and dev.type == "cuda":
        out(f"DOCTOR FAIL: asked for {p} shards but only {visible} "
            "devices are visible")
        return 4
    ok, detail = _collective_probe(p, str(dev), timeout_s)
    out(f"collective: {detail}")
    if not ok:
        out(f"DOCTOR FAIL: {detail}")
        return 5
    if checkpoint_path:
        ck_ok, lines = _checkpoint_probe(checkpoint_path, p)
        for ln in lines:
            out(f"checkpoint: {ln}")
        if not ck_ok:
            out(f"DOCTOR FAIL: {lines[-1]}")
            return 6
        directory = (os.path.dirname(os.path.abspath(checkpoint_path))
                     or ".")
        disk_ok, detail = _free_disk_probe(directory, MIN_FREE_BYTES)
        out(f"checkpoint: disk: {detail}")
        if not disk_ok:
            out(f"DOCTOR FAIL: {detail}")
            return 8
    if data_path:
        data_ok, code = _data_probe(data_path, out)
        if not data_ok:
            return code
    if coordinator or hosts_dir:
        hg_ok, why = _hostgroup_probe(coordinator, hosts_dir,
                                      num_hosts, heartbeat_max_age_s,
                                      timeout_s, out)
        if not hg_ok:
            out(f"DOCTOR FAIL: host group degraded — {why}")
            return 9
    if serving_url:
        _serving_tenant_probe(serving_url, out)
    out(f"DOCTOR OK: {p}-shard mesh sane"
        + (", checkpoint path healthy" if checkpoint_path else "")
        + (", shard data healthy" if data_path else "")
        + (", host group healthy" if coordinator or hosts_dir else ""))
    return 0

