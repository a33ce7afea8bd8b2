"""AST repo lint + hot-path behaviour lint (port of
``repro/analysis/lint.py``).

Two layers, one diagnostic currency:

**Module lint** (:func:`lint_paths` / :func:`lint_source`) - repo hygiene
checks over source files, framework-neutral and the reference's rule for
rule:

* ``lint-unused-import``  - imported name never referenced (re-export files
  - ``__init__.py`` - are skipped; ``# noqa`` lines are honored; names in
  ``__all__`` count as used).
* ``lint-mutable-default`` - a mutable literal (``{}``/``[]``/``set()``/
  ``dict()``/``list()``) as a default parameter value: shared across calls,
  and unhashable if it feeds a cache key.
* ``lint-shadowed-import`` - a module-level import later rebound at module
  level.

**Hot-path lint** (:func:`lint_behavior` / :func:`lint_hot_fn`) - the
static complement of the step audit (``analysis.step_audit``), over a
behaviour's ``pair_fn`` / ``update_fn`` source.  The reference's rules,
severities and taint propagation; only the wording is eager PyTorch's:

* ``hot-python-branch`` - Python ``if``/``while`` whose test references an
  *agent-data* argument (agent attrs, accumulators, masks, keys).  In
  eager PyTorch that is no trace error: ``bool()`` of a tensor copies it
  to the host on every call, a device->host read that stalls the card's
  queue (and that a captured CUDA graph cannot hold).  ``params`` and
  ``dt`` are static Python values, so branching on them is legal and not
  flagged; ``x is None`` structure checks are whitelisted.
* ``hot-host-sync`` - ``.item()`` anywhere, or ``float()``/``int()``/
  ``bool()`` applied to an agent-data value: a device round-trip per call.
* ``hot-numpy`` - ``np.*`` / ``numpy.*`` inside a hot function: host numpy
  runs on the host every step, and reading a device tensor into it is a
  device->host copy.

Tainting is first-order and deliberately conservative: a name assigned
from an expression that references an agent-data name *outside any call*
is agent data too; values returned by calls are not tainted (so structure
checks on results like ``child is not None`` stay clean).  The step audit
catches what this heuristic misses.
"""

from __future__ import annotations

import ast
import inspect
import pathlib
import textwrap
from typing import Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.diagnostics import Diagnostic

CONTRACT_UNUSED_IMPORT = "lint-unused-import"
CONTRACT_MUTABLE_DEFAULT = "lint-mutable-default"
CONTRACT_SHADOWED_IMPORT = "lint-shadowed-import"
CONTRACT_HOT_BRANCH = "hot-python-branch"
CONTRACT_HOT_SYNC = "hot-host-sync"
CONTRACT_HOT_NUMPY = "hot-numpy"

# behaviour arguments that are static Python values, not agent data
_STATIC_ARGS = {"params", "dt", "self", "cls"}

_MUTABLE_CTORS = {"dict", "list", "set"}


# ---------------------------------------------------------------------------
# Module lint
# ---------------------------------------------------------------------------

def _noqa_lines(src: str) -> Set[int]:
    return {i + 1 for i, line in enumerate(src.splitlines())
            if "# noqa" in line}


def _import_bindings(tree: ast.AST):
    """Yield (name, lineno) for every module-scope import binding."""
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                yield name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                yield (alias.asname or alias.name), node.lineno
        elif isinstance(node, ast.If):
            # imports under `if TYPE_CHECKING:` and friends
            for sub in ast.walk(node):
                if isinstance(sub, (ast.Import, ast.ImportFrom)):
                    fake = ast.Module(body=[sub], type_ignores=[])
                    yield from _import_bindings(fake)


def _used_names(tree: ast.AST) -> Set[str]:
    used: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # module attribute chains root at a Name, already collected
            pass
        elif (isinstance(node, ast.Constant)
              and isinstance(node.value, str)):
            continue
    # names re-exported through __all__ count as used
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)):
            for sub in ast.walk(node.value):
                if (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)):
                    used.add(sub.value)
    return used


def _check_unused_imports(tree, filename: str,
                          noqa: Set[int]) -> List[Diagnostic]:
    if pathlib.Path(filename).name == "__init__.py":
        return []  # re-export modules import on purpose
    used = _used_names(tree)
    out = []
    for name, lineno in _import_bindings(tree):
        if lineno in noqa or name in used or name == "_":
            continue
        out.append(Diagnostic(
            severity="warning", contract=CONTRACT_UNUSED_IMPORT,
            message=f"import {name!r} is never used",
            hint="delete the import (or mark an intentional re-export "
                 "with `# noqa`)",
            location=f"{filename}:{lineno}"))
    return out


def _is_mutable_default(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                         ast.ListComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in _MUTABLE_CTORS)


def _check_mutable_defaults(tree, filename: str,
                            noqa: Set[int]) -> List[Diagnostic]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            if _is_mutable_default(d) and d.lineno not in noqa:
                out.append(Diagnostic(
                    severity="warning", contract=CONTRACT_MUTABLE_DEFAULT,
                    message=(f"function {node.name!r} has a mutable "
                             "default argument: it is shared across "
                             "calls and unhashable as a cache key"),
                    hint="default to None and construct inside, or use a "
                         "frozen/tuple default",
                    location=f"{filename}:{d.lineno}"))
    return out


def _bound_names(target: ast.AST):
    """Names an assignment target actually (re)binds - Subscript/Attribute
    targets mutate an object, they do not rebind the name."""
    if isinstance(target, ast.Name):
        yield target.id, target.lineno
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from _bound_names(e)
    elif isinstance(target, ast.Starred):
        yield from _bound_names(target.value)


def _check_shadowed_imports(tree, filename: str,
                            noqa: Set[int]) -> List[Diagnostic]:
    imports = {name: lineno for name, lineno in _import_bindings(tree)}
    out = []
    body = tree.body if isinstance(tree, ast.Module) else []
    for node in body:
        names = []
        if isinstance(node, ast.Assign):
            for t in node.targets:
                names.extend(_bound_names(t))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.append((node.name, node.lineno))
        for name, lineno in names:
            if (name in imports and lineno > imports[name]
                    and lineno not in noqa):
                out.append(Diagnostic(
                    severity="warning", contract=CONTRACT_SHADOWED_IMPORT,
                    message=(f"module-level {name!r} shadows the import "
                             f"at line {imports[name]}"),
                    hint="rename one of the two bindings",
                    location=f"{filename}:{lineno}"))
    return out


def lint_source(src: str, filename: str = "<source>") -> List[Diagnostic]:
    """Module-level lint over one source string."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Diagnostic(
            severity="error", contract="lint-syntax",
            message=f"syntax error: {e.msg}",
            location=f"{filename}:{e.lineno}")]
    noqa = _noqa_lines(src)
    out: List[Diagnostic] = []
    out.extend(_check_unused_imports(tree, filename, noqa))
    out.extend(_check_mutable_defaults(tree, filename, noqa))
    out.extend(_check_shadowed_imports(tree, filename, noqa))
    return out


def lint_paths(paths: Iterable[str]) -> List[Diagnostic]:
    """Module lint over files and directories (recursing into ``*.py``)."""
    files: List[pathlib.Path] = []
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        else:
            files.append(path)
    out: List[Diagnostic] = []
    for f in files:
        out.extend(lint_source(f.read_text(), str(f)))
    return out


# ---------------------------------------------------------------------------
# Hot-path lint (behavior pair/update functions)
# ---------------------------------------------------------------------------

def _names_in(node: ast.AST, *, skip_calls: bool) -> Set[str]:
    """Names referenced in an expression; ``skip_calls`` prunes call
    subtrees (used by the taint propagation so call *results* stay
    untainted)."""
    found: Set[str] = set()

    def visit(n):
        if skip_calls and isinstance(n, ast.Call):
            return
        if isinstance(n, ast.Name):
            found.add(n.id)
        for child in ast.iter_child_nodes(n):
            visit(child)

    visit(node)
    return found


def _is_none_check(test: ast.AST) -> bool:
    """``x is None`` / ``x is not None`` (static structure checks)."""
    if not isinstance(test, ast.Compare):
        return False
    return all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)


def _traced_args(fdef, static_args: Optional[Set[str]] = None) -> Set[str]:
    """The arguments that hold agent data (the reference's traced ones)."""
    static = _STATIC_ARGS if static_args is None else static_args
    names = [a.arg for a in fdef.args.args + fdef.args.kwonlyargs]
    return {n for n in names
            if n not in static and not n.startswith("_")}


def _propagate_taint(fdef, traced: Set[str]) -> Set[str]:
    """First-order fixpoint: a name assigned from an expression that
    references an agent-data name outside any call is agent data too."""
    traced = set(traced)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fdef):
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AugAssign):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            else:
                continue
            if not (_names_in(value, skip_calls=True) & traced):
                continue
            for t in targets:
                for sub in ast.walk(t):
                    if (isinstance(sub, ast.Name)
                            and sub.id not in traced):
                        traced.add(sub.id)
                        changed = True
    return traced


def lint_hot_fn(fn, label: str = "",
                static_args: Optional[Set[str]] = None) -> List[Diagnostic]:
    """Hot-path lint of one pair/update function via its source.

    ``static_args`` overrides the default set of argument names that hold
    no agent data (:data:`_STATIC_ARGS`).  The ensemble contract passes a
    set *without* ``params``: the ensemble's lanes hold parameters as
    per-lane tensors (``core.ensemble``), so branching on them - legal in
    a solo engine - reads every lane's value to the host."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError):
        return []  # no retrievable/parsable source (lambda, C ext, REPL)
    fdef = next((n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef,
                                   ast.AsyncFunctionDef))), None)
    if fdef is None:
        return []
    code = getattr(fn, "__code__", None)
    base_line = (code.co_firstlineno - fdef.lineno) if code else 0
    filename = code.co_filename if code else "<source>"

    def loc(node) -> str:
        return f"{label or fn.__name__} ({filename}:" \
               f"{node.lineno + base_line})"

    traced = _propagate_taint(fdef, _traced_args(fdef, static_args))
    out: List[Diagnostic] = []
    for node in ast.walk(fdef):
        if isinstance(node, (ast.If, ast.While)):
            if _is_none_check(node.test):
                continue
            if _names_in(node.test, skip_calls=False) & traced:
                kw = "while" if isinstance(node, ast.While) else "if"
                out.append(Diagnostic(
                    severity="error", contract=CONTRACT_HOT_BRANCH,
                    message=(f"Python `{kw}` on agent data inside a hot "
                             "function: bool() of a tensor is a "
                             "device->host read on every call, stalling "
                             "the card's queue (and no CUDA graph can "
                             "capture it)"),
                    hint="use torch.where (or a mask multiply) instead of "
                         "Python control flow on agent data",
                    location=loc(node)))
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "item":
                out.append(Diagnostic(
                    severity="error", contract=CONTRACT_HOT_SYNC,
                    message="`.item()` in a hot function: forces a "
                            "device->host transfer on every call",
                    hint="keep the value as a tensor; reduce with torch "
                         "ops",
                    location=loc(node)))
            elif (isinstance(func, ast.Name)
                  and func.id in ("float", "int", "bool")
                  and any(_names_in(a, skip_calls=False) & traced
                          for a in node.args)):
                out.append(Diagnostic(
                    severity="error", contract=CONTRACT_HOT_SYNC,
                    message=(f"`{func.id}()` applied to agent data: "
                             "host conversion inside the hot path"),
                    hint="use .to(dtype) / tensor casts on tensors",
                    location=loc(node)))
        elif (isinstance(node, ast.Name)
              and node.id in ("np", "numpy")
              and isinstance(node.ctx, ast.Load)):
            out.append(Diagnostic(
                severity="warning", contract=CONTRACT_HOT_NUMPY,
                message="host numpy used inside a hot function: the call "
                        "runs on the host every step (and a device tensor "
                        "read into it is a device->host copy)",
                hint="use torch ops on the agent tensors in behavior "
                     "kernels",
                location=loc(node)))
    return out


def lint_behavior(behavior, name: str = "behavior",
                  static_args: Optional[Set[str]] = None
                  ) -> List[Diagnostic]:
    """Hot-path lint over every leaf pair/update function of a behaviour
    stack (composed wrappers are framework code and recursed through, not
    linted themselves)."""
    out: List[Diagnostic] = []

    def rec(b, path):
        children = tuple(getattr(b, "children", ()) or ())
        if children:
            for i, c in enumerate(children):
                rec(c, f"{path}.b{i}")
            return
        out.extend(lint_hot_fn(b.pair_fn, f"{path}.pair_fn",
                               static_args=static_args))
        out.extend(lint_hot_fn(b.update_fn, f"{path}.update_fn",
                               static_args=static_args))

    rec(behavior, name)
    return out


def lint_behaviors(behaviors: Sequence, name: str = "behavior"
                   ) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for i, b in enumerate(behaviors):
        out.extend(lint_behavior(b, f"{name}[{i}]"))
    return out
