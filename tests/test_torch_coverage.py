"""Every public top-level name of the JAX package has a counterpart in the
port's module of the same path, or stands on the exclusion list below with
its reason (ROADMAP.md mirrors the list). Both packages are parsed with
`ast`; nothing is imported.
"""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "sqrtlm_slam_tpu")
PORT_PKG = os.path.join(REPO, "sqrtlm_slam_tpu_torch")

# The port module that stands for a JAX module of another name.
COUNTERPART = {"optim/assembly_pallas.py": "optim/assembly.py"}

_LANES = "the TPU lane layout (landmarks on 128 lanes); the port's K2 / K3 wrappers take (L, K)"
EXCLUDED = {
    "optim/assembly_pallas.py": {
        "prepare": _LANES, "PreparedObs": _LANES, "LANES": _LANES,
        "AssemblyRows": _LANES, "assemble_prepared_rows": _LANES,
        "assemble_prepared": _LANES + " (assemble)",
        "chi2_prepared": _LANES + " (chi2_sum)",
    },
    "ops/hamming.py": {
        "hamming_matrix_pallas": "the TPU kernel; its CUDA counterpart is hamming_matrix_cuda",
        "hamming_matrix_reference": "the plain version; the port's is hamming_matrix_plain",
    },
    "lidar/features.py": {
        "extract_features_jit": "a jit bucket; PyTorch runs eagerly",
        "pad_cloud": "pads clouds to jit buckets; nothing to compile in the port",
    },
    "pipeline/frame.py": {
        "build_frame_jit": "a jit bucket; PyTorch runs eagerly",
        "build_frame_stereo_jit": "a jit bucket; PyTorch runs eagerly",
    },
    "utils/cache.py": {
        "enable_persistent_cache": "the XLA compile cache; PyTorch compiles nothing",
    },
    "optim/schur_bucketed.py": {
        "ChunkPlan": "TPU layout: the banded chunked S-Gram",
        "plan_chunks": "TPU layout: the banded chunked S-Gram",
        "RowsPieces": "TPU layout: the 128-lane rows layout",
        "back_substitute_rows": "TPU layout: the 128-lane rows layout",
        "cg_reduce_and_solve_rows": "TPU layout: the 128-lane rows layout",
    },
}


def _public_names(path, with_imports: bool):
    """Top-level defs, classes and assigned names (and, with_imports,
    imported names) that do not start with an underscore."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _modules():
    for root, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), JAX_PKG).replace(os.sep, "/")


def test_every_public_name_has_a_counterpart():
    missing = {}
    for rel in _modules():
        want = _public_names(os.path.join(JAX_PKG, rel), with_imports=False)
        port = os.path.join(PORT_PKG, COUNTERPART.get(rel, rel))
        have = _public_names(port, with_imports=True) if os.path.exists(port) else set()
        gap = sorted(want - have - set(EXCLUDED.get(rel, {})))
        if gap:
            missing[rel] = gap
    assert not missing, missing


def test_exclusions_are_real_and_still_unported():
    """Each excluded name exists in the JAX module and is still absent from
    the port (an entry that the port has gained, or that the JAX package
    dropped, must leave the list)."""
    for rel, names in EXCLUDED.items():
        want = _public_names(os.path.join(JAX_PKG, rel), with_imports=False)
        port = os.path.join(PORT_PKG, COUNTERPART.get(rel, rel))
        have = _public_names(port, with_imports=True) if os.path.exists(port) else set()
        for name, reason in names.items():
            assert name in want, (rel, name)
            assert name not in have, (rel, name)
            assert reason
