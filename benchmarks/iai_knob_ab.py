"""Depth-knob A/B matrix for the flagship warm IAI leg.

The warm scan leg is depth-bound, not eval-bound (docs/DESIGN.md): three
nested while_loops whose trip counts multiply, each iteration far below
device saturation.  The levers are shipped as default-preserving knobs
(--iai-chunk / --iai-leaf-nbisect / --iai-inner-seed-width); CPU eval
counts mis-rank them (extra evals ride in idle vmap lanes), so the
ranking A/B runs on the device and is recorded as multi-run spreads.

Each config runs ``examples/aps_example.py --with-iai --skip-ptr`` in a
subprocess, parses the IAI wall + eval telemetry off stderr, checks the
DOS values against the first config's (the knobs must not change
results), and appends a JSON line to the log so the sweep is
restartable.

Usage: python benchmarks/iai_knob_ab.py [--reps 2] [--log FILE]
       [--configs NAME ...]
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> extra argv for aps_example.py
CONFIGS = {
    "shipped": [],
    "leaf4": ["--iai-leaf-nbisect", "4"],
    "seedw8": ["--iai-inner-seed-width", "8"],
    "leaf4+seedw8": ["--iai-leaf-nbisect", "4", "--iai-inner-seed-width", "8"],
    "chunk66": ["--iai-chunk", "66"],
    "chunk16": ["--iai-chunk", "16"],
    "leaf2": ["--iai-leaf-nbisect", "2"],
    "seedw16": ["--iai-inner-seed-width", "16"],
    "presplit4": ["--iai-leaf-presplit", "4"],
    "presplit8": ["--iai-leaf-presplit", "8"],
    "presplit4+seedw8": ["--iai-leaf-presplit", "4",
                         "--iai-inner-seed-width", "8"],
    "cold": ["--cold-iai"],
    # block=W: W adjacent omegas share ONE adaptive nest — the structural
    # lever against the depth-bound leg (divides the sequential solve
    # count W-fold).  chunk must be a block multiple.  Blocks widen every
    # nest tensor W-fold, so inner_cap derates to bound live memory.
    "cap64": ["--iai-inner-cap", "64"],
    "block2": ["--iai-block", "2", "--iai-chunk", "32",
               "--iai-inner-cap", "64"],
    "block4": ["--iai-block", "4", "--iai-chunk", "32",
               "--iai-inner-cap", "64"],
    "block8": ["--iai-block", "8", "--iai-chunk", "32",
               "--iai-inner-cap", "32"],
    "block4+cold": ["--iai-block", "4", "--iai-chunk", "32",
                    "--iai-inner-cap", "64", "--cold-iai"],
    # batch 2 (round 5): cap ladder + GK-order depth lever + crash-safe
    # block retries (block x cap64 crashed the worker at full interp
    # density; cap32 survived for block8)
    "cap32": ["--iai-inner-cap", "32"],
    "order11+cap64": ["--iai-order", "11", "--iai-inner-cap", "64"],
    "order15+cap64": ["--iai-order", "15", "--iai-inner-cap", "64"],
    "chunk66+cap64": ["--iai-chunk", "66", "--iai-inner-cap", "64"],
    "block2+cap32": ["--iai-block", "2", "--iai-chunk", "32",
                     "--iai-inner-cap", "32"],
    "block4+cap32": ["--iai-block", "4", "--iai-chunk", "32",
                     "--iai-inner-cap", "32"],
    # batch 3 (round 5): refinement-WIDTH levers — wider per-trip
    # processing cuts serial trips at masked-lane eval cost
    "nbisect2+cap64": ["--iai-nbisect", "2", "--iai-inner-cap", "64"],
    "nbisect4+cap64": ["--iai-nbisect", "4", "--iai-inner-cap", "64"],
    "innb4+cap64": ["--iai-inner-nbisect", "4", "--iai-inner-cap", "64"],
    "nbisect2+innb4+cap64": ["--iai-nbisect", "2", "--iai-inner-nbisect",
                             "4", "--iai-inner-cap", "64"],
    # r5 shipped defaults (cap64 + inner_nbisect 4 after the default flip)
    "r5-default": [],
    "seedw8+cap64": ["--iai-inner-seed-width", "8", "--iai-inner-cap", "64"],
    "seedw16+cap64": ["--iai-inner-seed-width", "16",
                      "--iai-inner-cap", "64"],
    "warmw32+cap64": ["--iai-warm-width", "32", "--iai-inner-cap", "64"],
    "order11+chunk66+cap64": ["--iai-order", "11", "--iai-chunk", "66",
                              "--iai-inner-cap", "64"],
    # batch 4 (round 5): innb4 (inner_nbisect=4 — mid-level trips halved at
    # IDENTICAL evals, 177 s rep0) is the first real depth win; push it
    "innb8+cap64": ["--iai-inner-nbisect", "8", "--iai-inner-cap", "64"],
    "innb4+order11+cap64": ["--iai-inner-nbisect", "4", "--iai-order", "11",
                            "--iai-inner-cap", "64"],
    "innb4+chunk66+cap64": ["--iai-inner-nbisect", "4", "--iai-chunk", "66",
                            "--iai-inner-cap", "64"],
    "innb4+seedw16+cap64": ["--iai-inner-nbisect", "4",
                            "--iai-inner-seed-width", "16",
                            "--iai-inner-cap", "64"],
    "innb4+block2+cap32": ["--iai-inner-nbisect", "4", "--iai-block", "2",
                           "--iai-chunk", "32", "--iai-inner-cap", "32"],
}

WALL_RE = re.compile(r"IAI interpolant \((\w[\w-]*)\): ([0-9.]+)s"
                     r"(?:, ([0-9.e+]+) integrand evals over (\d+) omegas)?")


def run_one(name, extra, rep):
    out_npz = f"/tmp/iai_ab_{name.replace('+', '_')}_{rep}.npz"
    cmd = [sys.executable, os.path.join(ROOT, "examples", "aps_example.py"),
           "--with-iai", "--skip-ptr", "--out", out_npz] + extra
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          timeout=3600)
    wall_total = time.time() - t0
    rec = {"config": name, "rep": rep, "wall_total_s": round(wall_total, 1),
           "rc": proc.returncode, "ts": time.time()}
    m = WALL_RE.search(proc.stderr)
    if m:
        rec["iai_wall_s"] = float(m.group(2))
        if m.group(3):
            rec["evals"] = float(m.group(3))
            rec["omegas"] = int(m.group(4))
    cm = re.search(r"IAI chunk evals: (.+)", proc.stderr)
    if cm:
        rec["chunk_evals"] = [float(v) for v in cm.group(1).split()]
    am = re.search(r"IAI DOS\(12\.5 eV\) = ([0-9.\-]+)", proc.stderr)
    if am:
        rec["iai_dos_125"] = float(am.group(1))
    if proc.returncode != 0:
        rec["stderr_tail"] = proc.stderr[-2000:]
    else:
        rec["npz"] = out_npz
    return rec


def _logged_cold_curve(log):
    """Cold reference curve from a previously logged run, if one survives."""
    if not os.path.exists(log):
        return None
    best = None
    with open(log) as fh:
        for line in fh:
            r = json.loads(line)
            if r.get("config") == "cold" and r.get("rc") == 0 \
                    and r.get("npz") and os.path.exists(r["npz"]):
                best = r["npz"]
    if best is None:
        return None
    try:
        return np.load(best)["dos_iai"]
    except Exception:
        return None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--log", default="/tmp/iai_knob_ab.jsonl")
    p.add_argument("--configs", nargs="*", default=None,
                   help="subset of config names (default: all)")
    args = p.parse_args(argv)

    names = args.configs or list(CONFIGS)
    # the COLD curve is the correctness reference for every warm config
    # (both certify the same abstol, so max|dDOS| <= ~2x abstol) — run it
    # first so every later record carries max_dos_delta_vs_cold
    if "cold" in names:
        names = ["cold"] + [n for n in names if n != "cold"]
    done = set()
    if os.path.exists(args.log):
        with open(args.log) as fh:
            for line in fh:
                r = json.loads(line)
                if r.get("rc") == 0:
                    done.add((r["config"], r["rep"]))

    cold_dos = _logged_cold_curve(args.log)
    for rep in range(args.reps):
        for name in names:
            if (name, rep) in done:
                print(f"skip {name} rep{rep} (logged)", file=sys.stderr)
                continue
            rec = run_one(name, CONFIGS[name], rep)
            tag = f"{name} rep{rep}"
            if rec["rc"] != 0:
                with open(args.log, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
                print(f"FAIL {tag}: rc={rec['rc']}", file=sys.stderr)
                continue
            dos = np.load(rec["npz"])["dos_iai"]
            if name == "cold" and cold_dos is None:
                cold_dos = dos
            elif cold_dos is not None:
                # warm (or re-run cold) vs the cold reference: both curves
                # carry the same abstol certificate, so the delta is bounded
                # by the certificate sum — a larger delta is a BUG, not
                # "expected warm drift" (VERDICT r4 weak #2)
                delta = float(np.max(np.abs(dos - cold_dos)))
                rec["max_dos_delta_vs_cold"] = delta
                if delta > 2e-3:
                    print(f"WARN {tag}: DOS delta vs cold {delta:.2e} "
                          "exceeds the certificate sum", file=sys.stderr)
            with open(args.log, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
            print(f"done {tag}: iai={rec.get('iai_wall_s')}s "
                  f"evals/omega={rec.get('evals', 0) / max(rec.get('omegas', 1), 1):.3g}"
                  f" dDOSvsCold={rec.get('max_dos_delta_vs_cold', float('nan')):.2e}"
                  f" DOS125={rec.get('iai_dos_125')}",
                  file=sys.stderr)


if __name__ == "__main__":
    main()
