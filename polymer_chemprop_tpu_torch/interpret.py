"""Model interpretation via Monte Carlo Tree Search substructure rationales
(reference interpret.py:17-363).

Searches for the minimal substructure whose predicted property stays above
``prop_delta``: the molecule is clustered into non-ring bonds + rings, MCTS
prunes peripheral clusters, and candidate subgraphs are scored by the
trained model through the batched predictor. Host-side search; device-side
scoring.

The port's copy of polymer_chemprop_tpu interpret.py: each scoring call
runs the port's ``make_predictions`` on ``args.device`` (CUDA unless the
caller asks for the CPU), which reads the checkpoints again each time, as
the JAX package's scoring does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Set

from .chem import parse_smiles
from .chem.write import extract_subgraph_smiles
from .config import PredictConfig
from .train.make_predictions import make_predictions

MIN_ATOMS = 8  # reference interpret.py:14 (overridden by --min_atoms)
C_PUCT = 10.0


class ChempropModel:
    """Checkpoint-ensemble scoring wrapper (reference interpret.py:17-75)."""

    def __init__(self, args: PredictConfig, property_id: int = 1):
        self.args = args
        self.property_index = property_id - 1

    def __call__(self, smiles: List[List[str]]) -> List[float]:
        preds, idx_map = make_predictions(
            PredictConfig(checkpoint_dir=self.args.checkpoint_dir,
                          checkpoint_path=self.args.checkpoint_path,
                          checkpoint_paths=self.args.checkpoint_paths,
                          batch_size=self.args.batch_size,
                          device=self.args.device),
            smiles=smiles, return_index_map=True)
        # an extracted fragment that fails to parse scores -inf so MCTS
        # never selects it as a rationale (keeps list alignment intact)
        return [preds[idx_map[i]][self.property_index] if i in idx_map
                else float("-inf") for i in range(len(smiles))]


class MCTSNode:
    """(reference interpret.py:78-101)."""

    def __init__(self, smiles: str, atoms: Set[int], W: float = 0,
                 N: int = 0, P: float = 0):
        self.smiles = smiles
        self.atoms = set(atoms)
        self.children: List["MCTSNode"] = []
        self.W = W
        self.N = N
        self.P = P

    def Q(self) -> float:
        return self.W / self.N if self.N > 0 else 0.0

    def U(self, n: int, c_puct: float = C_PUCT) -> float:
        return c_puct * self.P * math.sqrt(n) / (1 + self.N)


def find_clusters(mol) -> tuple:
    """Non-ring bonds + rings as clusters (reference interpret.py:103-130)."""
    n_atoms = mol.n_atoms
    if n_atoms == 1:
        return [(0,)], [[0]]
    clusters = [(b.a1, b.a2) for b in mol.bonds if not b.in_ring]
    clusters.extend(tuple(ring) for ring in mol.sssr())
    atom_cls = [[] for _ in range(n_atoms)]
    for i, cls in enumerate(clusters):
        for atom in cls:
            atom_cls[atom].append(i)
    return clusters, atom_cls


def mcts_rollout(node: MCTSNode, state_map: Dict[str, MCTSNode], mol,
                 clusters, atom_cls, nei_cls,
                 scoring_function: Callable[[List[List[str]]], List[float]],
                 min_atoms: int, c_puct: float) -> float:
    """(reference interpret.py:203-255)."""
    cur_atoms = node.atoms
    if len(cur_atoms) <= min_atoms:
        return node.P

    if len(node.children) == 0:
        cur_cls = {i for i, x in enumerate(clusters) if x <= cur_atoms}
        for i in cur_cls:
            leaf_atoms = [a for a in clusters[i]
                          if len(atom_cls[a] & cur_cls) == 1]
            if len(nei_cls[i] & cur_cls) == 1 or \
                    (len(clusters[i]) == 2 and len(leaf_atoms) == 1):
                new_atoms = cur_atoms - set(leaf_atoms)
                new_smiles = extract_subgraph_smiles(mol, new_atoms)
                if new_smiles in state_map:
                    new_node = state_map[new_smiles]
                else:
                    new_node = MCTSNode(new_smiles, new_atoms)
                if new_smiles:
                    node.children.append(new_node)
        state_map[node.smiles] = node
        if len(node.children) == 0:
            return node.P
        scores = scoring_function([[x.smiles] for x in node.children])
        for child, score in zip(node.children, scores):
            child.P = score

    sum_count = sum(c.N for c in node.children)
    selected = max(node.children, key=lambda x: x.Q() + x.U(sum_count, c_puct))
    v = mcts_rollout(selected, state_map, mol, clusters, atom_cls, nei_cls,
                     scoring_function, min_atoms, c_puct)
    selected.W += v
    selected.N += 1
    return v


def mcts(smiles: str,
         scoring_function: Callable[[List[List[str]]], List[float]],
         n_rollout: int, max_atoms: int, prop_delta: float,
         min_atoms: int = MIN_ATOMS, c_puct: float = C_PUCT) -> List[MCTSNode]:
    """(reference interpret.py:258-294)."""
    mol = parse_smiles(smiles, strict=False)
    if mol is None:
        return []
    if mol.n_atoms > 50:
        n_rollout = 1
    clusters_raw, atom_cls_raw = find_clusters(mol)
    clusters = [set(c) for c in clusters_raw]
    nei_cls = []
    for i, cls in enumerate(clusters):
        nbrs = {nei for atom in cls for nei in atom_cls_raw[atom]} - {i}
        nei_cls.append(nbrs)
    atom_cls = [set(x) for x in atom_cls_raw]

    root = MCTSNode(smiles, set(range(mol.n_atoms)))
    state_map = {smiles: root}
    for _ in range(n_rollout):
        mcts_rollout(root, state_map, mol, clusters, atom_cls, nei_cls,
                     scoring_function, min_atoms, c_puct)
    return [node for node in state_map.values()
            if len(node.atoms) <= max_atoms and node.P >= prop_delta]


def interpret(args: PredictConfig,
              data_path: str,
              property_id: int = 1,
              rollout: int = 20,
              max_atoms: int = 20,
              min_atoms: int = 8,
              c_puct: float = 10.0,
              prop_delta: float = 0.5,
              writer=print,
              save_svg_dir: Optional[str] = None) -> List[tuple]:
    """Batch interpretation CLI core (reference interpret.py:296-342).

    With ``save_svg_dir``, each rationale is also rendered as an SVG of
    the full molecule with the rationale atoms highlighted (our stand-in
    for the RDKit drawing the reference ecosystem would use).
    """
    import csv as _csv
    import os as _os
    model = ChempropModel(args, property_id)
    if save_svg_dir:
        from .chem.depict import depict_svg
        _os.makedirs(save_svg_dir, exist_ok=True)

    with open(data_path) as f:
        reader = _csv.reader(f)
        next(reader)
        all_smiles = [row[0] for row in reader]

    results = []
    writer("smiles,score,rationale,rationale_score")
    scores = model([[s] for s in all_smiles])
    for smiles, score in zip(all_smiles, scores):
        if score <= prop_delta:
            writer(f"{smiles},{score:.3f},,")
            results.append((smiles, score, None, None))
            continue
        rationales = mcts(smiles, model, rollout, max_atoms, prop_delta,
                          min_atoms, c_puct)
        if len(rationales) == 0:
            writer(f"{smiles},{score:.3f},,")
            results.append((smiles, score, None, None))
        else:
            min_size = min(len(x.atoms) for x in rationales)
            min_rationales = [x for x in rationales
                              if len(x.atoms) == min_size]
            rats = sorted(min_rationales, key=lambda x: x.P, reverse=True)
            writer(f"{smiles},{score:.3f},{rats[0].smiles},{rats[0].P:.3f}")
            results.append((smiles, score, rats[0].smiles, rats[0].P))
            if save_svg_dir:
                mol = parse_smiles(smiles, strict=False)
                if mol is not None:
                    svg = depict_svg(mol,
                                     highlight_atoms=sorted(rats[0].atoms))
                    fname = f"rationale_{len(results) - 1}.svg"
                    with open(_os.path.join(save_svg_dir, fname), "w") as fh:
                        fh.write(svg)
    return results


def chemprop_interpret(argv: Optional[List[str]] = None) -> None:
    """CLI entry (reference interpret.py:345-363; InterpretArgs
    args.py:691-728)."""
    import argparse
    parser = argparse.ArgumentParser(prog="chemprop_interpret")
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--checkpoint_dir")
    parser.add_argument("--checkpoint_path")
    parser.add_argument("--batch_size", type=int, default=500)
    parser.add_argument("--property_id", type=int, default=1)
    parser.add_argument("--rollout", type=int, default=20)
    parser.add_argument("--max_atoms", type=int, default=20)
    parser.add_argument("--min_atoms", type=int, default=8)
    parser.add_argument("--c_puct", type=float, default=10.0)
    parser.add_argument("--prop_delta", type=float, default=0.5)
    parser.add_argument("--save_svg_dir", default=None,
                        help="write rationale-highlighted structure SVGs")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    ns = parser.parse_args(argv)
    args = PredictConfig(checkpoint_dir=ns.checkpoint_dir,
                         checkpoint_path=ns.checkpoint_path,
                         batch_size=ns.batch_size, device=ns.device)
    interpret(args, ns.data_path, ns.property_id, ns.rollout, ns.max_atoms,
              ns.min_atoms, ns.c_puct, ns.prop_delta,
              save_svg_dir=ns.save_svg_dir)
