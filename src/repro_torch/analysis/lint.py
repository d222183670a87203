"""AST lint rules for hot-path discipline in eager PyTorch.

Port of ``repro/analysis/lint.py``: the same registry, ``Finding`` /
``render``, ``HotPathSpec``, ``lint_source`` / ``lint_file`` /
``lint_tree`` and allow pragma, with the rules that exist in eager
PyTorch rewritten for it.

Rules (each has a kebab-case ID, a fix hint, and an inline escape hatch):

- ``host-sync`` — a construct that makes the host wait for the device
  inside a hot-path scope: ``.item()``, ``.cpu()``, ``.numpy()``,
  ``.tolist()`` of a device-tainted value, ``torch.cuda.synchronize()``
  and any ``<event or stream>.synchronize()``; ``int()/float()/bool()``
  of a device-tainted value; ``np.asarray``/``np.array`` of a
  device-tainted value; and an ``if``/``while``/``assert`` or
  conditional expression whose test is a device-tainted value. The last
  is the eager form of the reference's ``tracer-branch``: where JAX
  traces a branch on a tracer, eager PyTorch calls ``bool()`` on the
  tensor, a hidden sync.
- ``late-closure`` — a nested ``def``/``lambda`` reading a local variable
  that is first assigned *after* the nested function's definition line;
  the closure sees whatever the name holds when it runs, as in the
  reference.
- ``device-constant`` — a large literal list/tuple (>= 64 scalar
  elements) passed to ``torch.tensor``/``torch.as_tensor`` inside a
  hot-path scope: each call copies it host→device again; build it once
  at module scope (or once per device).

The reference's ``missing-donate`` has no eager counterpart: there is no
``jax.jit`` whose carry could be donated, a carry is updated in place or
it is not. The runtime check :func:`repro_torch.analysis.op_check.
verify_in_place` takes its place (a carry keeps its storage and no
allocation of its size happens during the call).

Suppression: append ``# repro: allow(rule-id) <reason>`` on the finding
line, the line directly above it, or the ``def`` line of the enclosing
function (which suppresses the rule for the whole function body). The
pragma is rule-specific, and one without a reason suppresses nothing.

Device taint is the reference's single-pass, per-function dataflow:
names become tainted when assigned from ``torch.*``/``F.*`` calls (those
that return tensors), from calls of the port's kernel wrappers, from
attributes/names that conventionally hold device tensors (``_tok``,
``_pos``, ``_caches``, and the flush entries' ``"toks"``/``"ok"``/
``"ms"``), from parameters named like device carries, from method calls
and subscripts of tainted values. A tensor's metadata (``.shape``,
``.dtype``, ``.device``, ``.size()``, ``.numel()``, ...) is host data.
``np.asarray(x)`` and ``.cpu()``/``.tolist()``/``.item()`` results are
host values (taint cleared), so downstream ``int()`` calls on the
materialized copy do not double-report.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Sequence

__all__ = ["Rule", "RULES", "Finding", "HotPathSpec", "DEFAULT_SPEC",
           "ALL_HOT", "lint_source", "lint_file", "lint_tree", "pragmas"]

# ---------------------------------------------------------------------------
# Rule registry


@dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    hint: str


RULES: dict[str, Rule] = {
    r.id: r
    for r in [
        Rule(
            "host-sync",
            "device->host synchronization in a hot-path scope",
            "keep the value on device (torch.where / masked ops), or move "
            "the sync to a flush boundary and allowlist it with a "
            "justification",
        ),
        Rule(
            "late-closure",
            "closure reads a local assigned after the nested def",
            "bind the value as a default argument or define it before the "
            "nested function",
        ),
        Rule(
            "device-constant",
            "large literal tensor constructed inside a hot-path function",
            "hoist the constant to module scope (or cache it per device) so "
            "it is copied to the device once",
        ),
    ]
}

# ``# repro: allow(rule-id) reason`` — the reason is required.
_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\(([\w-]+)\)([^#]*)")

# Calls of these names return device tensors: the port's kernel wrappers
# and the model's device-side entry points.
_DEVICE_CALLS = {
    "paged_attention", "paged_attention_multi", "qkv_attention", "qmatmul",
    "qmatmul_qt", "aquant", "decode_step", "decode_step_spec",
    "decode_segment", "decode_segment_spec", "decode_many", "prefill",
    "prefill_extend", "forward_extend",
}
# Attributes / names conventionally holding device tensors in this codebase.
_DEVICE_NAMES = {"_tok", "_pos", "_caches"}
# Dict keys whose values are device tensors (flush entries).
_DEVICE_KEYS = {"toks", "ok", "ms"}
# Parameters that seed the taint set.
_DEVICE_PARAMS = {"caches", "carry", "tok", "pos"} | _DEVICE_NAMES

# A tensor's metadata lives on the host.
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "is_leaf"}
_HOST_METHODS = {"size", "dim", "numel", "nelement", "stride",
                 "element_size", "data_ptr", "is_contiguous",
                 "storage_offset", "get_device", "is_floating_point"}
# Methods that pull a tensor to the host (the result is host data).
_SYNC_METHODS_ALWAYS = {"item", "cpu", "numpy"}
_SYNC_METHODS_TAINTED = {"tolist"}
_MATERIALIZE_METHODS = _SYNC_METHODS_ALWAYS | _SYNC_METHODS_TAINTED
# ``torch.*`` functions that return host objects, not tensors.
_TORCH_HOST_FUNCS = {
    "device", "Size", "finfo", "iinfo", "Generator", "no_grad",
    "inference_mode", "enable_grad", "is_tensor", "is_floating_point",
    "is_complex", "is_grad_enabled", "is_inference_mode_enabled",
    "get_default_dtype", "set_default_dtype", "manual_seed",
    "set_grad_enabled", "promote_types", "result_type", "can_cast",
    "get_num_threads", "set_num_threads", "initial_seed", "typename",
}
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.utils.",
                        "torch.distributed.", "torch.profiler.",
                        "torch.testing.", "torch.autograd.",
                        "torch.nn.init.")
_TENSOR_ROOTS = {"torch", "F"}
_TENSOR_CTORS = {"tensor", "as_tensor"}

_COERCIONS = {"int", "float", "bool"}
_NP_MATERIALIZE = {"asarray", "array"}
_DEVICE_CONSTANT_MIN = 64


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    @property
    def hint(self) -> str:
        return RULES[self.rule].hint

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.rule}] {self.message}\n"
            f"    hint: {RULES[self.rule].hint}"
        )


# ---------------------------------------------------------------------------
# Hot-path scoping


@dataclass(frozen=True)
class HotPathSpec:
    """Which (file, function) pairs the hot-path rules apply to.

    ``dirs`` — every function in any file under these directories is hot.
    ``files`` — every function in these files is hot.
    ``func_substr`` — maps a file to a substring; only functions whose
    name contains the substring are hot in that file.
    """

    dirs: tuple[str, ...] = ()
    files: tuple[str, ...] = ()
    func_substr: tuple[tuple[str, str], ...] = ()

    def file_in_scope(self, rel: str) -> bool:
        rel = rel.replace("\\", "/")
        if any(rel == f for f in self.files):
            return True
        if any(d == "" or rel.startswith(d.rstrip("/") + "/") for d in self.dirs):
            return True
        return any(rel == f for f, _ in self.func_substr)

    def func_is_hot(self, rel: str, func_name: str) -> bool:
        rel = rel.replace("\\", "/")
        for f, sub in self.func_substr:
            if rel == f:
                return sub in func_name
        return self.file_in_scope(rel)


# The tree spec of ``python -m repro_torch.analysis.check_static``: the
# reference's (kernels and the serving scheduler/engine hot everywhere, the
# decode-path functions of the model stack) plus ``models/attention.py``,
# which every decode step runs.
DEFAULT_SPEC = HotPathSpec(
    dirs=("kernels",),
    files=("serving/scheduler.py", "serving/engine.py", "models/attention.py"),
    func_substr=(("models/transformer.py", "decode"),),
)

# Fixture/test spec: everything is hot.
ALL_HOT = HotPathSpec(dirs=("",), files=())


# ---------------------------------------------------------------------------
# Helpers over the AST


def _call_root(node: ast.AST) -> str | None:
    """Dotted-name root of a call target: torch.as_tensor -> 'torch'."""
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _literal_len(node: ast.AST) -> int:
    """Number of scalar constants in a (possibly nested) list/tuple literal."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return sum(_literal_len(e) for e in node.elts)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float, complex)):
        return 1
    if (
        isinstance(node, ast.BinOp)
        and isinstance(node.op, ast.Mult)
        and isinstance(node.right, ast.Constant)
        and isinstance(node.right.value, int)
    ):
        return _literal_len(node.left) * node.right.value
    return 0


def _torch_tensor_call(node: ast.Call) -> bool:
    """``torch.*`` / ``F.*`` call that returns a tensor."""
    root = _call_root(node.func)
    if root not in _TENSOR_ROOTS:
        return False
    dotted = _dotted(node.func) or ""
    if root == "F":
        return True
    if dotted.startswith(_TORCH_HOST_PREFIXES):
        return False
    return dotted.rsplit(".", 1)[-1] not in _TORCH_HOST_FUNCS


def _callee_name(node: ast.Call) -> str | None:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _is_materialize(value: ast.AST) -> bool:
    """``np.asarray(x)`` / ``x.cpu()`` / ``x.tolist()`` / ``x.item()``:
    the result is a host value."""
    if not isinstance(value, ast.Call) or not isinstance(value.func, ast.Attribute):
        return False
    if _call_root(value.func) == "np" and value.func.attr in _NP_MATERIALIZE:
        return True
    return value.func.attr in _MATERIALIZE_METHODS


class _TaintTracker:
    """Single-pass per-function device-taint approximation."""

    def __init__(self) -> None:
        self.tainted: set[str] = set()

    def expr_is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return False
            if node.attr in _DEVICE_NAMES:
                return True
            return self.expr_is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            if isinstance(node.slice, ast.Constant) and node.slice.value in _DEVICE_KEYS:
                return True
            return self.expr_is_tainted(node.value)
        if isinstance(node, ast.Call):
            if _is_materialize(node):
                return False
            if _torch_tensor_call(node):
                return True
            if _callee_name(node) in _DEVICE_CALLS:
                return True
            # method call on a tainted value: x.sum(), x.masked_fill(...)
            if isinstance(node.func, ast.Attribute) and self.expr_is_tainted(
                node.func.value
            ):
                return node.func.attr not in _HOST_METHODS
            return False
        if isinstance(node, ast.BinOp):
            return self.expr_is_tainted(node.left) or self.expr_is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr_is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.expr_is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # identity and membership tests never read a tensor's value
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.expr_is_tainted(node.left) or any(
                self.expr_is_tainted(c) for c in node.comparators
            )
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.expr_is_tainted(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.expr_is_tainted(node.body) or self.expr_is_tainted(node.orelse)
        if isinstance(node, ast.Starred):
            return self.expr_is_tainted(node.value)
        return False

    def _mark(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark(e, tainted)
        # Attribute/subscript targets: taint is tracked on the base name.

    def observe_assign(self, node: ast.Assign | ast.AugAssign | ast.AnnAssign) -> None:
        value = node.value
        if value is None:
            return
        tainted = self.expr_is_tainted(value)
        if isinstance(node, ast.Assign):
            for t in node.targets:
                self._mark(t, tainted)
        elif isinstance(node, ast.AugAssign):
            if tainted:             # x += device_value taints x; never clears
                self._mark(node.target, True)
        else:
            self._mark(node.target, tainted)


# ---------------------------------------------------------------------------
# Allow-pragma handling


def pragmas(source: str) -> list[tuple[int, str, str]]:
    """Every ``# repro: allow(rule-id) reason`` in ``source`` as
    ``(line, rule id, reason)``; ``reason`` is ``""`` when missing."""
    out = []
    for i, text in enumerate(source.splitlines(), start=1):
        for m in _ALLOW_RE.finditer(text):
            out.append((i, m.group(1), m.group(2).strip()))
    return out


class _Allowlist:
    def __init__(self, source_lines: Sequence[str]) -> None:
        # line number (1-based) -> set of allowed rule ids on that line; a
        # pragma without a reason allows nothing
        self.by_line: dict[int, set[str]] = {}
        for i, text in enumerate(source_lines, start=1):
            ids = {m.group(1) for m in _ALLOW_RE.finditer(text)
                   if m.group(2).strip()}
            if ids:
                self.by_line[i] = ids
        # def-line allows extend over the function body; filled by the linter.
        self.by_range: list[tuple[int, int, set[str]]] = []

    def add_function_scope(self, def_line: int, end_line: int) -> None:
        ids = self.by_line.get(def_line)
        if ids:
            self.by_range.append((def_line, end_line, set(ids)))

    def allows(self, line: int, rule: str) -> bool:
        for probe in (line, line - 1):
            if rule in self.by_line.get(probe, set()):
                return True
        return any(lo <= line <= hi and rule in ids for lo, hi, ids in self.by_range)


# ---------------------------------------------------------------------------
# The linter


class _Linter(ast.NodeVisitor):
    def __init__(self, rel_path: str, source: str, spec: HotPathSpec) -> None:
        self.rel = rel_path
        self.spec = spec
        self.lines = source.splitlines()
        self.allow = _Allowlist(self.lines)
        self.findings: list[Finding] = []
        self._func_stack: list[ast.FunctionDef] = []
        self._taint_stack: list[_TaintTracker] = []

    # -- driving ------------------------------------------------------------

    def run(self, tree: ast.Module) -> list[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.allow.add_function_scope(node.lineno,
                                              node.end_lineno or node.lineno)
        self.visit(tree)
        return self.findings

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if self.allow.allows(line, rule):
            return
        self.findings.append(Finding(self.rel, line, rule, message))

    def _in_hot_func(self) -> bool:
        if not self._func_stack:
            return False
        return self.spec.func_is_hot(self.rel, self._func_stack[0].name)

    @property
    def _taint(self) -> _TaintTracker | None:
        return self._taint_stack[-1] if self._taint_stack else None

    # -- function scoping ---------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_late_closure_container(node)
        self._func_stack.append(node)
        tracker = _TaintTracker()
        # Parameters named like device carries seed the taint set.
        for arg in list(node.args.args) + list(node.args.kwonlyargs):
            if arg.arg in _DEVICE_PARAMS:
                tracker.tainted.add(arg.arg)
        self._taint_stack.append(tracker)
        self.generic_visit(node)
        self._taint_stack.pop()
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    # -- assignments feed the taint tracker ---------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        if self._taint is not None:
            self._taint.observe_assign(node)

    visit_AugAssign = visit_Assign  # type: ignore[assignment]
    visit_AnnAssign = visit_Assign  # type: ignore[assignment]

    # -- host-sync: calls ---------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        hot = self._in_hot_func()
        taint = self._taint

        if hot and isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            recv_tainted = taint is not None and taint.expr_is_tainted(
                node.func.value)
            if attr in _SYNC_METHODS_ALWAYS and not node.args:
                self._emit(node, "host-sync",
                           f".{attr}() copies a tensor to the host")
            elif attr in _SYNC_METHODS_TAINTED and recv_tainted:
                self._emit(node, "host-sync",
                           f".{attr}() of a device value copies it to the host")
            elif attr == "synchronize":
                self._emit(node, "host-sync",
                           f"{_dotted(node.func) or '.synchronize'}() "
                           "blocks the host on the device")

        if hot and taint is not None:
            # int()/float()/bool() on a tainted expression
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in _COERCIONS
                and node.args
                and taint.expr_is_tainted(node.args[0])
            ):
                self._emit(
                    node,
                    "host-sync",
                    f"{node.func.id}() on a device value pulls it to host",
                )
            # np.asarray / np.array on a tainted expression
            if (
                isinstance(node.func, ast.Attribute)
                and _call_root(node.func) == "np"
                and node.func.attr in _NP_MATERIALIZE
                and node.args
                and taint.expr_is_tainted(node.args[0])
            ):
                self._emit(
                    node,
                    "host-sync",
                    f"np.{node.func.attr}() of a device value forces a transfer",
                )

        # device-constant: big literal into a tensor constructor
        if (hot and isinstance(node.func, ast.Attribute)
                and _call_root(node.func) == "torch"
                and node.func.attr in _TENSOR_CTORS
                and node.args
                and _literal_len(node.args[0]) >= _DEVICE_CONSTANT_MIN):
            self._emit(
                node,
                "device-constant",
                f"literal tensor of {_literal_len(node.args[0])} elements "
                "built inside a hot function",
            )

        self.generic_visit(node)

    # -- host-sync: branches on a tensor (the eager tracer-branch) ----------

    def _branch(self, node: ast.AST, test: ast.AST, kind: str) -> None:
        taint = self._taint
        if self._in_hot_func() and taint is not None and taint.expr_is_tainted(test):
            self._emit(node, "host-sync",
                       f"`{kind}` on a device value calls bool() on it")

    def visit_If(self, node: ast.If) -> None:
        self._branch(node, node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._branch(node, node.test, "while")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._branch(node, node.test, "x if ... else y")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._branch(node, node.test, "assert")
        self.generic_visit(node)

    # -- late-closure -------------------------------------------------------

    def _check_late_closure_container(self, node: ast.FunctionDef) -> None:
        """For each nested def/lambda in `node`, flag reads of locals first
        assigned after the nested function's definition line."""
        assign_line: dict[str, int] = {}
        for a in list(node.args.args) + list(node.args.kwonlyargs):
            assign_line.setdefault(a.arg, node.lineno)
        nested: list[ast.FunctionDef | ast.Lambda] = []

        def scan(n: ast.AST) -> None:
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    nested.append(child)  # do not descend: its locals are its own
                    continue
                if isinstance(child, ast.Assign):
                    for t in child.targets:
                        for nm in _target_names(t):
                            assign_line.setdefault(nm, child.lineno)
                elif isinstance(child, (ast.AugAssign, ast.AnnAssign)):
                    for nm in _target_names(child.target):
                        assign_line.setdefault(nm, child.lineno)
                elif isinstance(child, ast.For):
                    for nm in _target_names(child.target):
                        assign_line.setdefault(nm, child.lineno)
                scan(child)

        scan(node)
        for fn in nested:
            own = _local_names(fn)
            for name_node in ast.walk(fn):
                if not isinstance(name_node, ast.Name) or not isinstance(
                    name_node.ctx, ast.Load
                ):
                    continue
                nm = name_node.id
                if nm in own:
                    continue
                first = assign_line.get(nm)
                if first is not None and first > fn.lineno:
                    self._emit(
                        fn,
                        "late-closure",
                        f"closure reads {nm!r}, first assigned at line {first} "
                        f"(after the def at line {fn.lineno})",
                    )
                    break  # one finding per nested function is enough


def _target_names(t: ast.AST) -> Iterable[str]:
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _target_names(e)


def _local_names(fn: ast.FunctionDef | ast.Lambda) -> set[str]:
    names: set[str] = set()
    args = fn.args
    for a in list(args.args) + list(args.kwonlyargs) + list(args.posonlyargs):
        names.add(a.arg)
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                names.add(node.id)
    return names


# ---------------------------------------------------------------------------
# Public API


def lint_source(
    source: str, rel_path: str = "<string>", spec: HotPathSpec = ALL_HOT
) -> list[Finding]:
    tree = ast.parse(source)
    return _Linter(rel_path, source, spec).run(tree)


def lint_file(path: str | Path, root: str | Path | None = None,
              spec: HotPathSpec = DEFAULT_SPEC) -> list[Finding]:
    path = Path(path)
    rel = str(path.relative_to(root)) if root is not None else path.name
    return lint_source(path.read_text(), rel, spec)


def lint_tree(
    root: str | Path,
    spec: HotPathSpec = DEFAULT_SPEC,
    exclude: Callable[[str], bool] | None = None,
) -> list[Finding]:
    """Lint every ``.py`` under ``root`` whose relative path is in scope."""
    root = Path(root)
    findings: list[Finding] = []
    for path in sorted(root.rglob("*.py")):
        rel = str(path.relative_to(root)).replace("\\", "/")
        if exclude is not None and exclude(rel):
            continue
        if not spec.file_in_scope(rel):
            continue
        findings.extend(lint_source(path.read_text(), rel, spec))
    return findings
