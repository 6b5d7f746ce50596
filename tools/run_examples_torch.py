"""Run the PyTorch port's ten examples (``examples/torch/01-10``) in one
process, each through its ``main`` at its default sizes (or the arguments
given after ``--``), and write each one's returned numbers and seconds as
JSON.

Usage: python tools/run_examples_torch.py [--device cuda|cpu] [--only 03,07]
       [--out chiprun_out/examples_torch.json] [-- extra example arguments]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"


def example_paths() -> dict[str, Path]:
    """``{"01": examples/torch/01_ingest.py, ...}``."""
    return {p.name[:2]: p for p in sorted(EXAMPLES.glob("[0-9][0-9]_*.py"))}


def load_example(number: str):
    """The example module ``number`` ("01".."10"), imported from its file."""
    from otto_tpu_torch.utils.runtime import load_file

    path = example_paths()[number]
    return load_file(path, f"otto_example_{path.stem}")


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "tolist"):
        return x.tolist() if getattr(x, "size", 2) <= 64 else f"array {list(x.shape)}"
    return x


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default="", help="comma-separated example numbers")
    ap.add_argument("--out", default="examples_torch.json")
    args = ap.parse_args(argv[:argv.index("--")] if "--" in argv else argv)
    sys.path.insert(0, str(REPO))
    from otto_tpu_torch.utils.runtime import device_line

    numbers = [n.strip().zfill(2) for n in args.only.split(",") if n.strip()] or \
        list(example_paths())
    results, failed = {"device": device_line(args.device)}, []
    print(f"# {results['device']}", flush=True)
    for n in numbers:
        print(f"\n### example {n}: {example_paths()[n].name}", flush=True)
        t0 = time.perf_counter()
        try:
            got = load_example(n).main(["--device", args.device, *extra])
        except Exception:  # report every example, then fail
            traceback.print_exc()
            failed.append(n)
            got = {"failed": True}
        secs = time.perf_counter() - t0
        results[n] = {"seconds": secs, **_jsonable(got)}
        print(f"### example {n}: {secs:.1f} s ({results['device']})", flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(f"# wrote {args.out}; failed: {failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
