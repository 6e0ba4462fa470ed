"""The port does all that the JAX package does: its public surface, read
from the JAX package's source.

Each `.py` module of `maveric_slam_tpu/` is read with `ast` (nothing of the
JAX package is imported), and the port's module at the same path under
`maveric_slam_tpu_torch/` is imported. For every module, the port's has:
- every public top-level function, class and constant of the JAX module;
- every public method of each of its classes (private classes too, since
  the engine's private helpers have public methods), and each class's
  constructor parameters;
- for every public function and method, each parameter the JAX one takes,
  except `key`, by name (or a `**kwargs` that takes it).

What has no counterpart by name is in EXCEPTIONS, each with its reason and
what the port does instead, and nothing else is; every entry must still be
missing from the port, so that the table cannot outlive its reason.
"""

import ast
import importlib
import inspect
import pathlib

import pytest
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_ROOT = ROOT / "maveric_slam_tpu"

# JAX name -> (why it has no twin, the port's counterpart). A name is
# "module.py", "module.py:name" or "module.py:Class.method"; "*:key" is every
# parameter named `key`.
EXCEPTIONS = {
    "ops/pallas_kernels.py": ("TPU kernels", "ops/kernels/* and csrc/*.cu"),
    "ops/backend.py:use_tpu_pallas": ("TPU only", "ops/backend.resolve_device and the dispatch in "
                                                  "ops/kernels"),
    "ops/backend.py:is_mxu_backend": ("TPU only", "ops/backend.resolve_device and the dispatch in "
                                                  "ops/kernels"),
    "utils/profiling.py:xla_trace": ("TPU only", "utils/profiling.trace"),
    "data/refdata.py:REFERENCE_ROOT": ("names the absent source",
                                       "none: the port's refdata reads only the shipped _refcache"),
    "slam.py:_StepPacker.pack_head": ("private", "none"),
    "*:key": ("JAX PRNG keys", "a torch.Generator or injected noise"),
}


def _modules():
    return sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


def _params(fn: ast.FunctionDef):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _accepts(obj, names):
    """The names of `names` that callable `obj` does not accept."""
    params = inspect.signature(obj).parameters
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return []
    return [n for n in names if n not in params]


def _public_top_level(tree):
    """(name, node) of every public function, class (private classes too:
    their methods are checked) and constant at the module's top level."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_") or isinstance(node, ast.ClassDef):
                yield node.name, node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    yield t.id, node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if not node.target.id.startswith("_"):
                yield node.target.id, node


def surface_gaps(rel: str):
    """What the port's module at `rel` lacks of the JAX module's surface,
    as "rel:name", "rel:Class.method" or "rel:function(parameter)"."""
    tree = ast.parse((JAX_ROOT / rel).read_text())
    name = "maveric_slam_tpu_torch." + ".".join(pathlib.PurePath(rel).with_suffix("").parts)
    try:
        mod = importlib.import_module(name.removesuffix(".__init__"))
    except ModuleNotFoundError:
        return [rel]
    gaps = []
    for n, node in _public_top_level(tree):
        if not hasattr(mod, n):
            if not n.startswith("_"):
                gaps.append(f"{rel}:{n}")
            continue
        obj = getattr(mod, n)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            gaps += [f"{rel}:{n}({p})" for p in _accepts(obj, _params(node))]
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if sub.name == "__init__":
                    gaps += [f"{rel}:{n}({p})" for p in _accepts(obj, _params(sub))]
                elif not sub.name.startswith("_"):
                    if not hasattr(obj, sub.name):
                        gaps.append(f"{rel}:{n}.{sub.name}")
                    elif not isinstance(inspect.getattr_static(obj, sub.name), property):
                        gaps += [f"{rel}:{n}.{sub.name}({p})"
                                 for p in _accepts(getattr(obj, sub.name), _params(sub))]
    return gaps


def _excepted(gap: str) -> bool:
    return gap in EXCEPTIONS or gap.endswith("(key)")


@pytest.mark.parametrize("rel", _modules())
def test_port_has_the_jax_modules_surface(rel):
    gaps = [g for g in surface_gaps(rel) if not _excepted(g)]
    assert not gaps, f"the port lacks {gaps}"


def test_every_exception_is_still_missing():
    """Each entry of EXCEPTIONS names something the port really lacks, in a
    module of the JAX package; `key` parameters exist and are all excepted."""
    gaps = {g for rel in _modules() for g in surface_gaps(rel)}
    named = [e for e in EXCEPTIONS if not e.startswith("*")]
    assert all(e.split(":")[0] in _modules() for e in named)
    assert set(named) <= gaps, set(named) - gaps
    assert any(g.endswith("(key)") for g in gaps)
    assert all(why and instead for why, instead in EXCEPTIONS.values())
