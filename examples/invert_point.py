#!/usr/bin/env python3
"""End-to-end single-point inversion demo (the reference's point.py
__main__ example, point.py:372-423): observed Cascadia dispersion ->
vmapped MCMC -> posterior plots.

Run:  JAX_PLATFORMS=cpu python examples/invert_point.py  (or on a GPU)

The module-level settings double as the Cascadia fixture of bench.py and
chip_smoke.py, so importing it needs nothing beyond the package:
matplotlib is imported by ``main`` only.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pysurfinv_tpu.inversion.point import PointCascadia, PostPointCascadia  # noqa: E402

setting = {
    "OceanWater": {"H": 2},
    "OceanSedimentCascadia": {"H": [1, "rel_pos", 100, 0.1]},
    "OceanCrust": {"H": 7, "Vs": [3.25, 3.94]},
    "OceanMantleHybrid": {
        "BottomDepth": 200, "Conversion": "Ritzwoller",
        "ThermAge": [4, "rel_pos", 200, 0.4],
        "Vs": [[0, "abs", 0.4, 0.01], [0, "abs", 0.4, 0.01],
               [0, "abs", 0.4, 0.01], [0, "abs", 0.2, 0.01]],
    },
    "Info": {"modelType": "CascadiaOcean", "period": 10,
             "refLayer": True, "lithoAgeQ": True},
}
localInfo = {
    "topo": -2.567706, "lithoAge": 0.6, "sedthk": 0.019,
    "mantleInitParmVs": [-0.3426920324186606, -0.1863907997418917,
                         -0.1882828662382096, -0.05648363217566826],
}
periods = [10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 32, 36, 40, 50, 60,
           70, 80]
vels = [3.5724066175576223, 3.6222019289297043, 3.6520621581430763,
        3.6588731735179367, 3.673255450218663, 3.683443600610537,
        3.6844591498161896, 3.689993791502759, 3.6935745493241487,
        3.696092260762209, 3.707185398688356, 3.7148258328900985,
        3.7209668755498257, 3.7486729577980427, 3.7706463827824748,
        3.82144353111797, 3.8603954933518914, 3.9030011211762767]
uncers = [0.006550350458769691, 0.005, 0.005, 0.005, 0.005, 0.005, 0.005,
          0.005, 0.005, 0.005, 0.005, 0.005499996722895128,
          0.00751713560920708, 0.007910350806141024, 0.007711019920661203,
          0.010152973423528881, 0.01062776863809981, 0.015829560954127662]


def main():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runN = int(os.environ.get("RUN_N", 2400))
    chainL = int(os.environ.get("CHAIN_L", 200))
    p = PointCascadia(setting, localInfo, periods=periods, vels=vels,
                      uncers=uncers)
    print("initial misfit:", p.misfit()[0])
    p.MCinvMP("example_out", pid="229.8_47.0", runN=runN, chainL=chainL,
              seed=42)
    p.MCinvMP("example_out_priori", pid="229.8_47.0", runN=runN,
              chainL=chainL, seed=43, priori=True)

    post = PostPointCascadia("example_out/229.8_47.0.npz",
                             "example_out_priori/229.8_47.0.npz")
    print(f"accepted {post.accFinal.sum()}/{post.N}, "
          f"min misfit {post.minMod.misfit:.3f}, "
          f"avg-model misfit {post.avgMod.misfit:.3f}")
    post.plotDisp(ensemble=False)
    plt.savefig("example_out/dispersion.png", dpi=120)
    post.plotVsProfileGrid()
    plt.savefig("example_out/vs_profile.png", dpi=120)
    post._check_history("misfit")
    plt.savefig("example_out/misfit_history.png", dpi=120)

    # prior-vs-posterior QC (point.py:230-248): posterior histograms
    # (filled) against the priori chain's (outline) at three depths —
    # a posterior that just reproduces the prior means the data did not
    # constrain that depth
    plt.close("all")
    post._check_distribution(zdeps=[20.0, 60.0, 120.0])
    for i, z in enumerate((20, 60, 120)):
        plt.figure(plt.get_fignums()[i])
        plt.savefig(f"example_out_priori/hist_vs_at_{z}km.png", dpi=120)
    print("wrote example_out/*.png + example_out_priori/*.png")


if __name__ == "__main__":
    main()
