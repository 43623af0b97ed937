"""Stage 5 — melting curve assembly + plots
(reference: lammps_post.py; SURVEY.md §2.5); the port's copy of
``neuralmelting_tpu.cli.post``, numpy only.

    python -m neuralmelting_tpu_torch.cli.post -i out/remcmc.lj.fcc.4x4x4.melt.npz
"""

from __future__ import annotations

import argparse

import numpy as np

# literature anchors for overlays (BASELINE.md physics anchors)
LITERATURE = {
    "LJ": {"press": [0.0], "tm": [0.69],
           "label": "LJ triple point (literature)"},
    "AL": {"press": [1.0], "tm": [933.47],
           "label": "Al melting, 1 atm (experimental)"},
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", required=True, help="melt .npz")
    ap.add_argument("-e", "--element", default="LJ")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--no-plot", action="store_true")
    args = ap.parse_args(argv)

    z = np.load(args.input)
    press, tm, width = z["press"], z["tm"], z["width"]
    print("melting curve T_m(P):")
    for p, t, w in zip(press, tm, width):
        print(f"  P={p:12.4f}  T_m={t:12.4f}  (width {w:.4f})")

    out = args.out or args.input.replace(".melt.npz", ".curve.png")
    if not args.no_plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 4), dpi=120)
        ax.errorbar(press, tm, yerr=width, marker="o", capsize=3,
                    label="this work")
        lit = LITERATURE.get(args.element.upper())
        if lit:
            ax.scatter(lit["press"], lit["tm"], marker="*", s=120,
                       color="crimson", zorder=5, label=lit["label"])
        ax.set_xlabel("pressure")
        ax.set_ylabel("melting temperature")
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(out)
        print(f"plot -> {out}")


if __name__ == "__main__":
    main()
