#!/usr/bin/env python3
"""QM8 ingest for the port: molecules → three packed npz files.

Counterpart of ``scripts/get_qm8_data.py``, the same pipeline on a
machine with deepchem and rdkit (it never downloads anything itself;
deepchem's loader does, where it has the network):

    deepchem MoleculeNet QM8 (sdf + csv)
      → per molecule: atom types, per-bond-type dense adjacency, the 16
        regression targets (the graph dict of ``data/qm8.py``)
      → deepchem's random train/val/test split
      → ``lanczosnet_torch/data/dataset.py:pack_dataset`` per split (the
        operator stacks, the Ritz pairs on ``--device``, the labels
        standardized with the training split's statistics)
      → three .npz files with the JAX package's keys.

Point ``dataset.source: packed`` and ``{train,val,test}_path`` at them.
Without deepchem or rdkit the script exits 1 and names them.

    python3 scripts/torch_get_qm8_data.py --out data/qm8
    python3 scripts/torch_get_qm8_data.py --out data/qm8 --device cpu
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BOND_TYPES = ("SINGLE", "DOUBLE", "TRIPLE", "AROMATIC")
# atomic numbers of QM8 (H, C, N, O, F) → dense ids 1..5
Z_MAP = {1: 1, 6: 2, 7: 3, 8: 4, 9: 5}


def mol_to_graph(mol, label: np.ndarray, strict: bool = True) -> dict:
    """RDKit Mol → graph dict: atom type ids (``Z_MAP``), one adjacency
    per bond type, the 16 targets as float32.

    Unknown chemistry raises by default: aliasing an unexpected bond type
    to SINGLE, or an unexpected element to a spare id, would mis-encode
    the packed dataset. ``strict=False`` aliases instead (unknown
    elements to 6, unknown bonds to SINGLE) and records the aliases under
    ``_aliased`` for the caller to count and report.
    """
    zs = [a.GetAtomicNum() for a in mol.GetAtoms()]
    unknown_z = sorted({z for z in zs if z not in Z_MAP})
    if unknown_z and strict:
        raise ValueError(
            f"unexpected atomic numbers {unknown_z} (expected H/C/N/O/F); "
            "rerun with --allow-unknown to alias them to a spare id")
    atoms = np.asarray([Z_MAP.get(z, 6) for z in zs], np.int32)
    n = len(atoms)
    adj = np.zeros((len(BOND_TYPES), n, n), np.float32)
    unknown_bonds = []
    for b in mol.GetBonds():
        i, j = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
        bt = str(b.GetBondType())
        if bt in BOND_TYPES:
            e = BOND_TYPES.index(bt)
        elif strict:
            raise ValueError(
                f"unexpected bond type {bt!r} (expected {BOND_TYPES}); "
                "rerun with --allow-unknown to alias it to SINGLE")
        else:
            unknown_bonds.append(bt)
            e = 0
        adj[e, i, j] = adj[e, j, i] = 1.0
    g = {"atom_type": atoms, "adj": adj, "label": np.asarray(label).astype(np.float32)}
    if unknown_z or unknown_bonds:
        g["_aliased"] = {"atoms": unknown_z, "bonds": unknown_bonds}
    return g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="data/qm8")
    ap.add_argument("--n-max", type=int, default=32)
    ap.add_argument("--num-eig-vec", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--allow-unknown", action="store_true",
                    help="alias unknown bond types to SINGLE and unknown elements to a "
                         "spare id (counted and reported) instead of raising")
    ap.add_argument("--device", default=None,
                    help="where the Ritz pairs are computed (default: the card)")
    args = ap.parse_args(argv)

    try:
        import deepchem as dc
        from rdkit import Chem  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            f"deepchem/rdkit unavailable ({e}); run this on a machine with deepchem and "
            "rdkit, or use dataset.source: synthetic | reference_pickle instead")

    from lanczosnet_torch.data.dataset import pack_dataset, save_packed

    _, (train, valid, test), _ = dc.molnet.load_qm8(
        featurizer="Raw", splitter="random", reload=False)
    out = Path(args.out)
    stats = None
    for name, split in (("train", train), ("val", valid), ("test", test)):
        graphs = [mol_to_graph(mol, y, strict=not args.allow_unknown)
                  for mol, y in zip(split.X, split.y) if mol.GetNumAtoms() <= args.n_max]
        aliased = [g.pop("_aliased") for g in graphs if "_aliased" in g]
        if aliased:
            print(f"WARNING {name}: {len(aliased)} molecules had unknown chemistry aliased "
                  f"(first: {aliased[0]})")
        ds = pack_dataset(graphs, n_max=args.n_max, num_eig_vec=args.num_eig_vec,
                          stats=stats, standardize=True, device=args.device)
        stats = ds.stats or stats
        save_packed(ds, out / f"{name}.npz")
        print(f"{name}: {len(graphs)} molecules → {out}/{name}.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
