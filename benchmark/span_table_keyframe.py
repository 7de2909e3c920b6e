"""`benchmark.span_table` for the nuScenes keyframe cells, whose parent span
is a keyframe (`pmf.keyframe`):

    python3 -m benchmark.span_table_keyframe --workload CELL --seed N [--seconds S] [--out FILE]
"""
from __future__ import annotations

from benchmark import span_table


def main(argv=None) -> None:
    span_table.PARENTS.setdefault("keyframe", "pmf.keyframe")
    span_table.main(argv)


if __name__ == "__main__":
    main()
