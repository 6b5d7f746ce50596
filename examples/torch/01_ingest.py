"""Ingest example on the PyTorch port (the counterpart of
``examples/01_ingest.py``, which replaces the reference's otto-mors-dataset
ingest notebook).

Parses raw OTTO JSONL (or generates synthetic data when no path is given),
builds the columnar EventStore, writes chunked parquet and reads it back.
Ingest is host work; ``--device`` is checked all the same, as every
example's is (``cuda`` by default, an error without a card).

Run: python examples/torch/01_ingest.py [events.jsonl] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from otto_tpu_torch.data.synthetic import synthetic_events
from otto_tpu_torch.data.writers import read_chunked_parquet, write_chunked_parquet
from otto_tpu_torch.logging_utils import configure_logging
from otto_tpu_torch.utils.runtime import resolve_device


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?", help="a raw OTTO .jsonl file (default: synthetic data)")
    ap.add_argument("--sessions", type=int, default=10_000)
    ap.add_argument("--aids", type=int, default=2_000)
    ap.add_argument("--chunk-sessions", type=int, default=2_000)
    ap.add_argument("--out-dir", default=None,
                    help="where the parquet chunks go (default: a new temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    configure_logging()

    if args.path:
        from otto_tpu_torch.data.ingest import read_jsonl

        store = read_jsonl(args.path)
    else:
        store = synthetic_events(n_sessions=args.sessions, n_aids=args.aids)

    lengths = store.lengths
    print(store)
    print("lengths: mean %.1f max %d" % (lengths.mean(), lengths.max()))
    out_dir = Path(args.out_dir or tempfile.mkdtemp(prefix="otto_chunks_"))
    paths = write_chunked_parquet(store, out_dir, chunk_sessions=args.chunk_sessions)
    back = read_chunked_parquet(out_dir)
    same = all((getattr(back, c) == getattr(store, c)).all()
               for c in ("session_idx", "aid", "ts", "type"))
    print(f"{len(paths)} parquet chunks in {out_dir}, read back equal: {same}")
    if not same:
        raise RuntimeError("the parquet chunks did not read back equal to the store")
    return {"n_events": int(store.n_events), "n_sessions": int(store.n_sessions),
            "mean_length": float(lengths.mean()), "max_length": int(lengths.max()),
            "chunks": len(paths), "out_dir": str(out_dir), "read_back_equal": same}


if __name__ == "__main__":
    main()
