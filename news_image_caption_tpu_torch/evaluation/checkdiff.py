"""Compare two generations.jsonl runs caption-by-caption.

A copy of `news_image_caption_tpu/evaluation/checkdiff.py`: the port
imports nothing of the JAX package.
`tests/test_torch_evaluation_copies.py` holds the two equal.

Capability parity target: ttl/checkdiff.py:1-35 (manual
diff tooling, SURVEY.md §4) plus an ent_check-style integrity scan
(ttl/ent_check.py) over required record fields.

Usage:
  python -m news_image_caption_tpu_torch.evaluation.checkdiff A.jsonl B.jsonl
  python -m news_image_caption_tpu_torch.evaluation.checkdiff --check A.jsonl
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

REQUIRED_FIELDS = ("caption", "generation")
ENRICHED_FIELDS = ("caption_names", "generated_names",
                   "caption_entities", "generated_entities",
                   "gen_readability", "gen_np")


def load(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def diff_runs(path_a: str, path_b: str, limit: int = 20) -> Dict:
    """Pair records by caption text; report differing generations.

    Duplicate captions (one caption generated several times in a run)
    pair up FIFO — a dict keyed on caption would collapse them to the
    last record and miscount."""
    from collections import deque
    a, b = load(path_a), load(path_b)
    by_cap: Dict[str, deque] = {}
    for r in b:
        by_cap.setdefault(r["caption"], deque()).append(r)
    diffs, same, unmatched = [], 0, 0
    for r in a:
        queue = by_cap.get(r["caption"])
        if not queue:
            unmatched += 1
            continue
        other = queue.popleft()
        if r["generation"] == other["generation"]:
            same += 1
        else:
            diffs.append({"caption": r["caption"],
                          "a": r["generation"],
                          "b": other["generation"]})
    return {"total_a": len(a), "total_b": len(b), "same": same,
            "different": len(diffs), "unmatched": unmatched,
            "examples": diffs[:limit]}


def integrity_check(path: str) -> Dict:
    """Scan for missing/empty required fields (ent_check analog)."""
    problems: Dict[str, int] = {}
    n = 0
    for rec in load(path):
        n += 1
        for f in REQUIRED_FIELDS:
            if not rec.get(f):
                problems[f"missing_{f}"] = problems.get(
                    f"missing_{f}", 0) + 1
        for f in ENRICHED_FIELDS:
            if f not in rec:
                problems[f"unenriched_{f}"] = problems.get(
                    f"unenriched_{f}", 0) + 1
    return {"records": n, "problems": problems,
            "ok": not any(k.startswith("missing_") for k in problems)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("file_a")
    p.add_argument("file_b", nargs="?")
    p.add_argument("--check", action="store_true",
                   help="integrity-scan a single file")
    p.add_argument("--limit", type=int, default=20)
    args = p.parse_args(argv)
    if args.check or args.file_b is None:
        out = integrity_check(args.file_a)
    else:
        out = diff_runs(args.file_a, args.file_b, args.limit)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
