"""The paper's pipeline end to end on Sedov3D, on the PyTorch + CUDA
port (``repro_torch``), twin of ``examples/sedov_amr.py``:

  AMR generation -> Hilbert domain decomposition -> local trees with ghost
  zones -> tree pruning -> HDep write (RLE'd booleans + father-son delta
  compressed fields) -> PyMSES-style read-back -> global assembly ->
  threshold filter + slice "visualization" (paper fig. 8 analogue).

    PYTHONPATH=src python examples/torch/sedov_amr.py [--insitu] [--device cpu]

With ``--insitu`` the same tree additionally flows through the in-transit
engine with device reduction (compute -> device staging -> raster
kernels -> reduced HDep -> catalog) on ``--device`` (the GPU unless
``cpu`` is asked for; without a GPU it raises), and the catalog's slice
is checked against the post-hoc one.
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402

from repro_torch.core import decompose, prune  # noqa: E402
from repro_torch.hercule import HerculeDB, analysis, api  # noqa: E402
from repro_torch.insitu.device import resolve_device  # noqa: E402
from repro_torch.sim import amrgen, fields  # noqa: E402

ROOT = os.path.join(tempfile.gettempdir(), "hx_sedov_hdep_torch")
INSITU_ROOT = os.path.join(tempfile.gettempdir(), "hx_sedov_insitu_torch")
N_DOMAINS = 8


def run_insitu(tree, g, device):
    """Drive the in-transit engine with the generated tree and check its
    catalog slice against the post-hoc assembly ``g``: first single
    writer, then partitioned over contributor groups with the reduced
    domains merged back at read."""
    from repro_torch.insitu import Catalog, InTransitEngine, SliceReducer
    print(f"== in-transit flow (--insitu, device reduce on {device})")
    ref = analysis.slice_image(g, "density", axis=2, position=0.5,
                               resolution=128)
    for groups in (1, 2):
        root = INSITU_ROOT if groups == 1 else f"{INSITU_ROOT}_md{groups}"
        shutil.rmtree(root, ignore_errors=True)
        slicer = SliceReducer(field="density", axis=2, position=0.5,
                              resolution=128)
        engine = InTransitEngine(root, [slicer], policy="drop-oldest",
                                 domains=groups, device_reduce=True,
                                 device=device).start()
        engine.submit(0, tree)
        engine.close()
        cat = Catalog(root)
        img = cat.query(0, slicer.name)["image"]
        match = np.array_equal(img, ref, equal_nan=True)
        doms = cat.domains(0, slicer.name)
        print(f"   [domains={groups}] reduced contexts: {cat.steps()}, "
              f"written domains: {doms}, merged slice matches "
              f"post-hoc assembly: {match}")
        cat.query(0, slicer.name)
        print(f"   [domains={groups}] cache: {cat.cache_info()}")
        assert match, "in-transit slice diverged from post-hoc assembly"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--insitu", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the in-transit reduction (default: "
                         "the GPU; 'cpu' to run it on the CPU)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    shutil.rmtree(ROOT, ignore_errors=True)
    print("== Sedov3D AMR generation")
    field = fields.sedov()
    tree = amrgen.generate_tree(field, min_level=3, max_level=7,
                                threshold=1.15, level_factor=1.05)
    tree.validate()
    print(f"   global tree: {tree.n_nodes} nodes, {tree.n_leaves} leaves, "
          f"{tree.n_levels} levels")

    print(f"== Hilbert decomposition over {N_DOMAINS} domains + pruning")
    dom = decompose.assign_domains(tree, N_DOMAINS)
    index = decompose._LevelIndex(tree)
    db = HerculeDB.create(ROOT, kind="hdep", ncf=4)
    ctx = db.begin_context(0)
    raw_bytes = 0
    for d in range(N_DOMAINS):
        lt = decompose.local_tree(tree, dom, d, coarse_level=3, index=index)
        pt = prune.prune(lt)
        removed = prune.removed_fraction(lt, pt)
        api.write_object(ctx, "amr_tree", d, pt)
        raw_bytes += lt.n_nodes * (1 + 1 + 8 * len(lt.fields))
        print(f"   domain {d}: {lt.n_nodes} -> {pt.n_nodes} nodes "
              f"({removed*100:.1f} % pruned)")
    ctx.finalize(attrs={"case": "sedov3d"})
    data_dir = os.path.join(ROOT, "data")
    comp_bytes = sum(os.path.getsize(os.path.join(data_dir, f))
                     for f in os.listdir(data_dir))
    print(f"   HDep volume: {comp_bytes/1e6:.2f} MB "
          f"(~{raw_bytes/1e6:.2f} MB unpruned+uncompressed) in "
          f"{db.n_files()} files (NCF=4)")

    print("== PyMSES-style read-back + assembly")
    g = analysis.load_global_tree(db, 0)
    g.validate()
    print(f"   assembled: {g.n_nodes} nodes")

    print("== fig. 8 analogue: threshold filters on density")
    rho = g.fields["density"][~g.refine]
    hi = analysis.threshold(g, "density", lo=float(np.quantile(rho, 0.95)))
    lo = analysis.threshold(g, "density", hi=float(np.quantile(rho, 0.20)))
    print(f"   high-density cells (shock shell): {hi['coords'].shape[0]}")
    print(f"   low-density cells (evacuated interior): {lo['coords'].shape[0]}")

    img = analysis.slice_image(g, "density", axis=2, position=0.5,
                               resolution=128)
    out = os.path.join(ROOT, "density_slice.npy")
    np.save(out, img)
    # quick ASCII rendering of the blast shell
    q = np.nanquantile(img, [0.5, 0.8, 0.95])
    chars = np.full(img.shape, " ")
    chars[img > q[0]] = "."
    chars[img > q[1]] = "o"
    chars[img > q[2]] = "#"
    step = max(1, img.shape[0] // 32)
    for row in chars[::step]:
        print("   " + "".join(row[::step // 2 if step > 1 else 1]))
    print(f"   slice saved to {out}")

    if args.insitu:
        run_insitu(tree, g, device)


if __name__ == "__main__":
    main()
