"""Browser color-track post-processing.

Functional parity: make-colortrack-fordisplay.py (CN bed → bed9 heat
map, rounded CN clamped to [0, 10] via a fixed 11-color map, adjacent
same-color windows merged keeping the first thickStart and last
thickEnd) and tutorial-sample-results/write-color-key.py (the 11-row
legend bed). Rounding is Python round() — banker's rounding — exactly
as the reference (make-colortrack-fordisplay.py:69).
"""

from __future__ import annotations

CN_TO_COLOR = {
    0: "224,224,224",
    1: "160,160,160",
    2: "0,0,0",
    3: "0,0,153",
    4: "51,51,255",
    5: "0,255,255",
    6: "0,153,0",
    7: "255,255,0",
    8: "255,153,51",
    9: "153,76,0",
    10: "204,0,0",
}


def cn_color(cn: float) -> str:
    c = int(round(float(cn)))
    c = min(max(c, 0), 10)
    return CN_TO_COLOR[c]


def make_colortrack(cn_bed_path: str, track_name: str,
                    out_path: str | None = None) -> str:
    """CN bed → merged bed9 color track (<cn_bed>.bedColor by default)."""
    out_path = out_path or cn_bed_path + ".bedColor"
    rows = []
    with open(cn_bed_path) as f:
        for line in f:
            p = line.split()
            if len(p) < 4:
                continue
            rows.append((p[0], int(p[1]), int(p[2]), cn_color(float(p[3]))))

    merged = []
    for c, b, e, col in rows:
        if merged and merged[-1][0] == c and merged[-1][3] == col \
                and merged[-1][2] == b:
            prev = merged[-1]
            merged[-1] = (prev[0], prev[1], e, col, prev[4], e)
        else:
            merged.append((c, b, e, col, b, e))

    with open(out_path, "w") as f:
        for c, b, e, col, tb, te in merged:
            f.write(f"{c}\t{b}\t{e}\t{track_name}\t0\t.\t{tb}\t{te}\t{col}\n")
    return out_path


def write_color_key(out_path: str = "color-track.bed") -> str:
    """The 11-row legend bed (write-color-key.py)."""
    with open(out_path, "w") as f:
        for i in range(11):
            name = "10+" if i == 10 else str(i)
            f.write(f"chr1\t0\t1000\t{name}\t0\t.\t0\t1000\t{CN_TO_COLOR[i]}\n")
    return out_path
