#!/usr/bin/env python3
"""Set the file scenes' records of two scripts/profile_torch_scene.py reports
side by side (say a parent commit's and a change's): per scene, whether kind,
span, stream and text are equal record for record, and the largest sv_score
difference, absolute and relative to the larger magnitude of the pair.

    python3 scripts/compare_scene_records.py parent.json change.json

Prints one JSON object per scene that both reports hold records for.
"""
from __future__ import annotations

import json
import sys


def main() -> int:
    a, b = (json.load(open(p))["scenes"] for p in sys.argv[1:3])
    for name in a:
        ra, rb = a[name].get("records"), (b.get(name) or {}).get("records")
        # a file scene's records are dicts; the streaming and serving scenes
        # count theirs
        if not all(isinstance(r, list) and all(isinstance(x, dict) for x in r) for r in (ra, rb)):
            continue
        keys = ("kind", "start", "end", "stream", "text")
        same = len(ra) == len(rb) and all(
            all(x[k] == y[k] for k in keys) for x, y in zip(ra, rb))
        rel = max((abs(x["sv_score"] - y["sv_score"])
                   / max(abs(x["sv_score"]), abs(y["sv_score"]), 1e-12)
                   for x, y in zip(ra, rb) if x["sv_score"] is not None), default=0.0)
        diff = max((abs(x["sv_score"] - y["sv_score"]) for x, y in zip(ra, rb)
                    if x["sv_score"] is not None), default=0.0)
        print(json.dumps({"scene": name, "records": [len(ra), len(rb)],
                          "kind_span_stream_text_equal": same, "sv_score_max_abs_diff": diff,
                          "sv_score_max_rel_diff": rel}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
