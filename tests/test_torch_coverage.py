"""Every public top-level name of the JAX package has a counterpart in the
port's module of the same path, or stands on the exclusion list below with
its reason (ROADMAP.md mirrors the list). Below the top level the same holds
for the methods and properties of every public class, the fields of every
public NamedTuple and dataclass, and the parameter names of every public
function and method (`MEMBER_EXCLUDED` lists the deliberate differences).
Both packages are parsed with `ast`; nothing is imported.
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
    "utils/cache.py": {
        "enable_persistent_cache": "the XLA compile cache; a captured CUDA graph does not "
                                   "outlive its process",
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


# Parameters of the JAX package that the port does not take, by module and
# function (or Class.method), each with its reason.
_KEY = "a jax.random key; the port takes a torch.Generator (`generator`)"
_AXIS = "a pmap / shard_map mesh axis name; the port's Mesh lists its shards"
_INTRINSICS = "the port's K2 / K3 wrappers take one Camera (`cam`) for the five intrinsics"
_INTERPRET = "Pallas interpret mode; CPU tensors take the plain version in the port"
MEMBER_EXCLUDED = {
    "optim/assembly_pallas.py": {
        "assemble": {**{n: _INTRINSICS for n in ("fx", "fy", "cx", "cy", "bf")},
                     "interpret": _INTERPRET},
        "chi2_sum": {**{n: _INTRINSICS for n in ("fx", "fy", "cx", "cy", "bf")},
                     "interpret": _INTERPRET},
    },
    "optim/schur_bucketed.py": {
        "pieces_from_terms": {"y_bf16": "a TPU storage choice (bf16 Y); the port keeps float32"},
        "ba_iterate": {"use_pallas": "picks the Pallas kernel or XLA; the port picks by device"},
    },
    "pipeline/initializer.py": {"initialize_two_view": {"key": _KEY}},
    "pipeline/tracking.py": {"recover_pose_no_prior": {"key": _KEY}},
    "algorithm/pnp.py": {"ransac_pnp_2d3d": {"key": _KEY}, "ransac_pose_3d3d": {"key": _KEY}},
    "loop/sim3_solver.py": {"ransac_sim3": {"key": _KEY}},
    "parallel/dist_ba.py": {"make_distributed_ba_step": {"axis": _AXIS},
                            "make_bucketed_ba_step": {"axis": _AXIS},
                            "make_bucketed_lm_iterate": {"axis": _AXIS}},
    "parallel/multiprocess.py": {
        "initialize": {"platform": "an XLA platform name; the port takes `device` / `backend`"},
        "global_mesh": {"axis": _AXIS},
    },
}


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _public(name):
    return not name.startswith("_") or name == "__init__"


def _classes(path, with_imports: bool, seen=()):
    """Public classes of a module: {name: ({member: params or None}, fields)}
    (properties map to None). With `with_imports`, a class the module imports
    from a sibling module of the package counts as the module's own."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            members, fields = {}, []
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(b.name):
                    prop = any(isinstance(d, ast.Name) and d.id == "property"
                               for d in b.decorator_list)
                    members[b.name] = None if prop else _params(b)
                elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                    fields.append(b.target.id)
            out[node.name] = (members, fields)
        elif (with_imports and isinstance(node, ast.ImportFrom) and node.level == 1
              and node.module):
            src = os.path.join(os.path.dirname(path), *node.module.split(".")) + ".py"
            if os.path.exists(src) and src not in seen:
                theirs = _classes(src, True, seen + (path,))
                for a in node.names:
                    if a.name in theirs:
                        out[a.asname or a.name] = theirs[a.name]
    return out


def _functions(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    return {n.name: _params(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(n.name)}


def _member_gaps(rel):
    """What the port's module lacks below the top level: missing members,
    fields and parameters, as strings, less MEMBER_EXCLUDED."""
    port = os.path.join(PORT_PKG, COUNTERPART.get(rel, rel))
    if not os.path.exists(port):
        return []
    jax_path = os.path.join(JAX_PKG, rel)
    skip = set(EXCLUDED.get(rel, {}))
    allowed = MEMBER_EXCLUDED.get(rel, {})
    gaps = []

    def params(qual, want, have):
        gaps.extend(f"{qual}({p})" for p in want
                    if p not in have and p not in allowed.get(qual, {}))

    have_fn = _functions(port)
    for name, want in _functions(jax_path).items():
        if name in have_fn and name not in skip:
            params(name, want, have_fn[name])
    have_cls = _classes(port, with_imports=True)
    for name, (members, fields) in _classes(jax_path, with_imports=False).items():
        if name in skip:
            continue
        if name not in have_cls:
            gaps.append(f"{name}: not a class")
            continue
        their_members, their_fields = have_cls[name]
        gaps.extend(f"{name}.{f}" for f in fields if f not in their_fields)
        for m, want in members.items():
            if m not in their_members:
                gaps.append(f"{name}.{m}")
            elif want is not None:
                params(f"{name}.{m}", want, their_members[m] or [])
    return gaps


def test_every_public_member_field_and_parameter_has_a_counterpart():
    missing = {rel: gaps for rel in _modules() if (gaps := _member_gaps(rel))}
    assert not missing, missing


def test_member_exclusions_are_real_and_still_unported():
    """Each excluded parameter exists in the JAX function and is absent from
    the port's; where the reason is the key, the port takes a generator."""
    for rel, fns in MEMBER_EXCLUDED.items():
        jax_fns = _functions(os.path.join(JAX_PKG, rel))
        port_fns = _functions(os.path.join(PORT_PKG, COUNTERPART.get(rel, rel)))
        for fn, names in fns.items():
            for name, reason in names.items():
                assert name in jax_fns[fn], (rel, fn, name)
                assert name not in port_fns[fn], (rel, fn, name)
                assert reason
                if reason == _KEY:
                    assert "generator" in port_fns[fn], (rel, fn)
