#!/usr/bin/env python
"""On-card smoke test of the main path, in phases, in one process.

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # the sharded pipeline on 4 GPUs

Phases (one card):
  1. device     platform / device_kind / count and the card's name and
                power limit (nvidia-smi); fails unless the platform is gpu.
  2. tests      the `gpu`-marked tests (tests/test_on_card.py), run by
                pytest in a child process before this one touches the card.
  3. compile    the Pallas gridder and degridder at the perf problem
                (N 32, T 128, C 16, P 4, 24,500 subgrids); memory_analysis.
  4. oracle     both kernels against the f64 oracle at the 1e-5 gate, on 64
                subgrids of the perf observation and on a w ≠ 0 observation
                (Taylor rank > 1), at full widths.
  5. main path  at the full perf problem: both kernels against xla_v4 at
                precision HIGHEST; both pipelines against a host NumPy
                composition (np.fft, np.add.at, slicing).
  6. timing     each kernel against xla_v4, alternating, in one process;
                both pipelines with their stage split.

With --four-cards only the sharded pipeline (gridder → iDFT → grid
reduction → gather → DFT → degridder) runs, on a flat 4-device mesh, with
the grid reduced both ways (psum; psum_scatter + all_gather), against the
one-card pipeline.

Any failed phase makes the script exit non-zero. The last line of a passing
run is {"ok": true, "device": {...}} and nothing else.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    """`name, power.limit` of every card, from nvidia-smi (a child process
    that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return " | ".join(line.strip() for line in out.stdout.splitlines()
                      if line.strip())


class Smoke:
    def __init__(self, four_cards: bool):
        self.four_cards = four_cards
        self.failed = []
        self.card = "unknown card"

    def phase(self, name, fn, *args):
        t0 = time.time()
        try:
            out = fn(*args)
            say(name, f"ok ({time.time() - t0:.1f} s)")
            return out
        except Exception as exc:  # noqa: BLE001 — report, then fail the run
            traceback.print_exc()
            say(name, f"FAILED: {type(exc).__name__}: {exc}")
            self.failed.append(name)
            return None


def phase_tests():
    """The gpu-marked pytest cases, in a child that exits before this
    process reserves the card."""
    env = dict(os.environ, IDG_TEST_DEVICE="gpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", os.path.join(REPO, "tests",
                                                "test_on_card.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    say("tests", tail[0])
    if proc.returncode != 0 or "passed" not in tail[0] or "skipped" in tail[0]:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
        raise RuntimeError(f"gpu tests rc={proc.returncode}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded pipeline on 4 GPUs")
    args = ap.parse_args(argv)
    smoke = Smoke(args.four_cards)

    # ---- 1. device -------------------------------------------------------
    try:
        smoke.card = card_line()
    except Exception as exc:  # noqa: BLE001
        say("device", f"FAILED: nvidia-smi: {exc}")
        return 1
    say("device", f"card: {smoke.card}")
    if not args.four_cards:
        smoke.phase("tests", phase_tests)
    try:
        import jax

        from idg_tpu.config import setup_compilation_cache
    except ImportError as exc:
        say("device", f"FAILED: {exc} (run from the repository root)")
        return 1
    setup_compilation_cache()
    dev = jax.devices()[0]
    count = len(jax.devices())
    say("device", f"platform={dev.platform} kind={dev.device_kind} "
                  f"count={count}")
    if dev.platform != "gpu":
        say("device", "FAILED: no GPU")
        return 1
    if args.four_cards and count < 4:
        say("device", f"FAILED: --four-cards needs 4 GPUs, found {count}")
        return 1

    from idg_tpu.smoke import run_four_cards, run_one_card

    if args.four_cards:
        run_four_cards(smoke)
    else:
        run_one_card(smoke)
    if smoke.failed:
        say("summary", f"FAILED phases: {', '.join(smoke.failed)}")
        return 1
    say("summary", f"all phases passed on {smoke.card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
