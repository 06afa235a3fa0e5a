"""Per-device tuned-knob profiles (port of
``dpsvm_tpu/tuning/profile.py``): the persisted half of the measure ->
act loop.

``dpsvm tune`` (tuning/tuner.py) measures a bounded grid of
throughput-critical knobs on this machine's device and persists the
winners here: one JSON file, keyed by device kind (the card's name from
``torch.cuda.get_device_name``, the key the roofline table matches, or
``cpu``), each entry with its provenance: the git sha and timestamp of
the tuning run, the probe ledger rows behind every decision, and the
measured end-to-end win over the built-in defaults. Resolution then
consults the profile wherever a knob is still at its built-in default:

    explicit value  >  tuned profile  >  built-in default

* **Explicit always wins**: the CLI marks the knobs the operator set
  (even to the default value) and ``apply_tuned`` never touches them;
  any non-default config value is left alone too.
* **Opt-out**: ``--no-tuned`` on the consuming commands, or
  ``DPSVM_NO_TUNED=1`` process-wide. An EMPTY ``DPSVM_TUNED_PROFILE``
  disables profile resolution entirely (the ledger's convention; the
  test suite runs disabled).
* **Device mismatch invalidates**: an entry tuned on the H100 is never
  applied on ``cpu``, nor the reverse. A tuned point is a fact about one
  device's economics.
* **Provenance or nothing**: an entry missing its schema, git sha,
  timestamp or knob dict fails ``validate_entry`` and is ignored (a
  hand-edited profile degrades to the defaults, never to a crash).

The file format is the JAX package's, so either package reads a file the
other wrote when pointed at it. The port's default file is its own,
``dpsvm_tpu_torch/_ledger/tuned_profile.json`` (a directory git
ignores); ``DPSVM_TUNED_PROFILE`` and ``DPSVM_NO_TUNED`` keep the JAX
package's names and meaning.

Knob namespace (what resolution consumes):

    chunk_iters      -> SVMConfig.chunk_iters   (host poll cadence)
    cache_lines      -> SVMConfig.cache_size    (kernel-row cache)
    serve_max_batch  -> serve --max-batch       (bucket-ladder top rung)
    serve_hedge_ms   -> serve --hedge-ms        (hedged re-dispatch)

Unknown knob names load and are not consumed. Stdlib only: the CLI and
the doctor read a profile before any device is touched, and
``current_device_kind()`` without a device never initializes CUDA.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

PROFILE_ENV = "DPSVM_TUNED_PROFILE"
NO_TUNED_ENV = "DPSVM_NO_TUNED"
PROFILE_SCHEMA = 1

#: profile knob name -> SVMConfig field consumed by ``apply_tuned``.
TRAIN_KNOBS = {
    "chunk_iters": "chunk_iters",
    "cache_lines": "cache_size",
}

#: serving knob names consumed by ``cmd_serve`` (not SVMConfig fields).
SERVE_KNOBS = ("serve_max_batch", "serve_hedge_ms")


def default_profile_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_ledger", "tuned_profile.json")


def profile_path(explicit: Optional[str] = None) -> Optional[str]:
    """Resolve the profile file: explicit argument, else the env var
    (EMPTY env value = profiles disabled -> None), else the port's
    default (the ledger's resolution convention)."""
    if explicit:
        return explicit
    env = os.environ.get(PROFILE_ENV)
    if env is not None:
        return env or None
    return default_profile_path()


def opted_out() -> bool:
    return os.environ.get(NO_TUNED_ENV, "").strip() not in ("", "0")


def current_device_kind(device=None) -> Optional[str]:
    """The device kind a profile entry is keyed by: the card's name
    (``torch.cuda.get_device_name``) for a CUDA device, ``"cpu"`` for the
    CPU. Without a device: the current card's name when this process has
    already initialized CUDA, else None (never initializes CUDA)."""
    th = sys.modules.get("torch")
    if device is None:
        if th is None:
            return None
        try:
            if not th.cuda.is_initialized():
                return None
            return str(th.cuda.get_device_name())
        except Exception:
            return None
    import torch
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    return str(torch.cuda.get_device_name(dev))


def validate_entry(entry: dict) -> List[str]:
    """Provenance problems with one profile entry (empty = valid). An
    entry that cannot say where it came from is not applied."""
    problems: List[str] = []
    if not isinstance(entry, dict):
        return ["entry is not an object"]
    if entry.get("schema") != PROFILE_SCHEMA:
        problems.append(f"schema {entry.get('schema')!r} != "
                        f"{PROFILE_SCHEMA}")
    if not entry.get("device_kind"):
        problems.append("missing device_kind")
    if not entry.get("git_sha"):
        problems.append("missing git_sha provenance")
    if not entry.get("time"):
        problems.append("missing timestamp")
    knobs = entry.get("knobs")
    if not isinstance(knobs, dict):
        problems.append("knobs is not an object")
    else:
        for k, v in knobs.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                problems.append(f"knob {k!r} has non-numeric value "
                                f"{v!r}")
    if not isinstance(entry.get("probes", []), list):
        problems.append("probes is not a list")
    return problems


def load_profiles(path: Optional[str] = None) -> Dict[str, dict]:
    """Every entry in the profile file, keyed by device kind ({} for a
    missing, disabled or unparseable file: a damaged profile degrades to
    the built-in defaults, never to a crash)."""
    p = profile_path(path)
    if p is None or not os.path.exists(p):
        return {}
    try:
        with open(p) as fh:
            data = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return {}
    if not isinstance(data, dict):
        return {}
    profiles = data.get("profiles")
    return profiles if isinstance(profiles, dict) else {}


def active_entry(device_kind: Optional[str] = None,
                 path: Optional[str] = None) -> Optional[dict]:
    """The profile entry resolution would consult right now: the device
    kind's entry, provenance-valid, not opted out; None otherwise.
    ``device_kind=None`` reads ``current_device_kind()``."""
    if opted_out():
        return None
    profiles = load_profiles(path)
    if not profiles:
        return None
    dk = device_kind or current_device_kind()
    if not dk:
        return None
    entry = None
    for key, val in profiles.items():
        if str(key).lower() == str(dk).lower():
            entry = val
            break
    if entry is None or validate_entry(entry):
        return None
    # The entry's own recorded device kind must agree with the key it
    # sits under (a copied or renamed entry is a provenance lie).
    if str(entry.get("device_kind", "")).lower() != str(dk).lower():
        return None
    return entry


def tuned_value(entry: Optional[dict], knob: str):
    """The entry's value for one knob name, or None."""
    if not entry:
        return None
    v = (entry.get("knobs") or {}).get(knob)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return v


def apply_tuned(config, explicit: Sequence[str] = (),
                device_kind: Optional[str] = None,
                path: Optional[str] = None) -> Tuple[object, dict]:
    """Resolve an SVMConfig against the active profile.

    Returns ``(config, applied)``, ``applied`` mapping the SVMConfig
    fields that were replaced to their tuned values ({} when nothing
    applied). Precedence per knob:

    * named in ``explicit`` (the CLI's set-by-the-operator list, even
      when set TO the default value) -> untouched;
    * config value differs from the SVMConfig field default (an API
      caller chose it) -> untouched;
    * tuned value fails ``config.validate()`` against the rest of the
      config (a cache on a decomposition run) -> skipped, the other
      knobs still apply;
    * otherwise -> replaced with the tuned value.

    The JAX package never resolves its numpy golden-reference backend;
    the port has no ``backend`` field, so no such rule applies here."""
    import dataclasses

    entry = active_entry(device_kind=device_kind, path=path)
    if entry is None:
        return config, {}
    defaults = type(config)()
    explicit = set(explicit)
    applied: dict = {}
    for knob, field in TRAIN_KNOBS.items():
        v = tuned_value(entry, knob)
        if v is None or field in explicit:
            continue
        if getattr(config, field) != getattr(defaults, field):
            continue
        cand = dataclasses.replace(config, **{field: int(v)})
        try:
            cand.validate()
        except ValueError:
            continue
        config = cand
        applied[field] = int(v)
    return config, applied


def make_entry(device_kind: str, knobs: dict,
               probes: Optional[List[dict]] = None,
               win: Optional[dict] = None) -> dict:
    """One schema-valid profile entry with its provenance."""
    from dpsvm_tpu_torch.observability.ledger import git_sha
    return {
        "schema": PROFILE_SCHEMA,
        "device_kind": str(device_kind),
        "git_sha": git_sha() or "unknown",
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "knobs": dict(knobs),
        "probes": list(probes or []),
        "win": win,
    }


def save_entry(entry: dict, path: Optional[str] = None) -> str:
    """Merge one entry into the profile file under its device kind
    (a tmp file, then a rename; other devices' entries are kept)."""
    p = profile_path(path)
    if p is None:
        raise ValueError(
            f"tuned profiles are disabled ({PROFILE_ENV} is empty); "
            "pass an explicit --out path")
    problems = validate_entry(entry)
    if problems:
        raise ValueError(f"refusing to persist an invalid profile "
                         f"entry: {problems}")
    profiles = load_profiles(p)
    profiles[str(entry["device_kind"])] = entry
    os.makedirs(os.path.dirname(os.path.abspath(p)) or ".",
                exist_ok=True)
    tmp = f"{p}.tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"schema": PROFILE_SCHEMA, "profiles": profiles},
                  fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, p)
    return p


def provenance_tag(device_kind: Optional[str] = None,
                   path: Optional[str] = None) -> Optional[str]:
    """Compact ``"<device_kind>@<git_sha>"`` tag of the entry resolution
    would consult, or None: measurement rows carry it so that ledger
    history stays attributable to the knob set behind each number."""
    try:
        entry = active_entry(device_kind=device_kind, path=path)
    except Exception:
        return None
    if entry is None:
        return None
    return f"{entry['device_kind']}@{entry.get('git_sha', 'unknown')}"


def doctor_lines(device_kind: Optional[str] = None,
                 path: Optional[str] = None) -> List[str]:
    """What ``doctor`` prints about profile resolution: which entry is
    active (knobs and provenance), or exactly why none is."""
    p = profile_path(path)
    if p is None:
        return [f"tuned profiles disabled ({PROFILE_ENV} is empty)"]
    if opted_out():
        return [f"tuned profile OPT-OUT active ({NO_TUNED_ENV}=1) — "
                "built-in defaults in effect"]
    if not os.path.exists(p):
        return [f"no tuned profile at {p} (run `dpsvm tune` to "
                "measure one for this device)"]
    profiles = load_profiles(p)
    if not profiles:
        return [f"tuned profile {p} is unreadable or empty — "
                "built-in defaults in effect"]
    dk = device_kind or current_device_kind()
    entry = active_entry(device_kind=dk, path=p)
    if entry is None:
        have = ", ".join(sorted(profiles))
        return [f"profile {p} has no valid entry for this device "
                f"({dk!r}; entries: {have}) — built-in defaults in "
                "effect"]
    knobs = ", ".join(f"{k}={v}" for k, v in
                      sorted(entry["knobs"].items())) or "(no knobs)"
    lines = [f"active profile for {entry['device_kind']!r}: {knobs}",
             f"provenance: git {entry['git_sha']} at {entry['time']}, "
             f"{len(entry.get('probes', []))} probe row(s) [{p}]"]
    win = entry.get("win")
    if isinstance(win, dict) and win.get("speedup") is not None:
        lines.append(
            f"measured win: {win['speedup']:.2f}x vs defaults "
            f"({win.get('case', 'tuned_vs_default')}; compare gate "
            f"{'OK' if win.get('compare_ok') else 'NOT RUN'})")
    return lines
