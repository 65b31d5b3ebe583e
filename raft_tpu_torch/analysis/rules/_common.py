"""Shared predicates for the rule catalog (counterpart of
``raft_tpu/analysis/rules/_common.py``).

The JAX package's sync predicate is ``.item()`` / ``.tolist()`` /
``.block_until_ready()`` plus ``np.asarray`` / ``jax.device_get``, and its
taint is the result of any ``jax.*`` call. Eager torch syncs implicitly,
so the port's predicate covers what makes torch wait for a CUDA tensor:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.synchronize()``
  and ``torch.cuda.synchronize()``;
* ``int()`` / ``float()`` / ``bool()`` of a tensor expression, and
  ``np.asarray`` / ``np.array`` / ``np.ascontiguousarray`` of one;
* ``torch.nonzero``, ``Tensor.nonzero``, ``torch.masked_select`` and
  one-argument ``torch.where`` (each sizes its output from the data);
* boolean-mask indexing ``t[mask]`` where the rule can decide that
  ``mask`` is a boolean tensor (a comparison, ``~``/``&``/``|`` of one, a
  ``torch.isfinite``-style call, or a name bound to one of those);
* a blocking host→device copy of host data — ``torch.tensor(list,
  device=dev)``, ``torch.as_tensor(host, device=dev)``,
  ``torch.from_numpy(a).to(dev)`` or ``torch.tensor(list).to(dev)``
  without ``non_blocking=True`` — which torch finishes with a stream sync
  (torch's sync debug mode reports it on the card).

The tensor taint is the result of ``torch.*`` calls (``F`` included) and
of tensor methods, and whatever is assigned from those. ``.shape``,
``.ndim``, ``.dtype``, ``.device`` and ``len()`` stay static, as in the
JAX package.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from raft_tpu_torch.analysis.jit_regions import (dotted_name, resolve_name,
                                                 walk)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

#: method calls that copy device data to the host or wait for the device,
#: whatever the receiver (unless the receiver is known to live on the host)
HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: method calls that size their output from the data
DATA_SIZED_ATTRS = {"nonzero"}
#: functions that wait for the device or size their output from the data
HOST_SYNC_CALLS = {"torch.cuda.synchronize", "torch.nonzero",
                   "torch.masked_select", "torch.Tensor.nonzero"}
#: host conversions that sync when handed a tensor
HOST_ARRAY_CALLS = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}
HOST_SCALAR_CASTS = {"int", "float", "bool"}

#: ``torch.*`` names that return host metadata or objects, not tensors
METADATA_FNS = {
    "finfo", "iinfo", "device", "dtype", "is_tensor", "is_floating_point",
    "is_complex", "is_available", "current_stream", "current_device",
    "device_count", "get_device_name", "get_device_properties",
    "get_default_dtype", "Size", "mem_get_info", "memory_allocated",
    "max_memory_allocated", "memory_reserved", "Event", "Stream",
    "Generator", "manual_seed", "synchronize", "no_grad", "inference_mode",
    "promote_types", "result_type", "can_cast", "use_deterministic_algorithms",
    "set_num_threads", "get_num_threads", "is_initialized", "stream",
    "set_sync_debug_mode", "get_sync_debug_mode", "record_function",
}

#: tensor methods that return host values (or nothing a kernel reads)
HOST_RESULT_METHODS = {
    "item", "tolist", "numpy", "dim", "size", "numel", "nelement",
    "data_ptr", "element_size", "stride", "is_contiguous", "get_device",
    "storage_offset", "is_floating_point", "is_complex", "__len__",
    "untyped_storage", "record_stream", "synchronize",
}

#: tensor methods: their result is a tensor unless the receiver is known
#: to live on the host (a numpy call's result, a host copy)
TENSOR_METHODS = {
    "sum", "mean", "max", "min", "any", "all", "abs", "sqrt", "exp", "log",
    "argmax", "argmin", "norm", "prod", "std", "var", "count_nonzero",
    "reshape", "flatten", "squeeze", "t", "transpose", "clone", "detach",
    "sort", "unique", "cumprod", "round", "floor", "ceil", "sign", "square",
    "contiguous", "float", "half", "bfloat16", "double", "long", "short",
    "byte", "to", "cuda", "view", "view_as", "unsqueeze", "index_select",
    "index_add", "index_add_", "index_put", "index_put_", "masked_fill",
    "masked_fill_", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "gather", "new_zeros", "new_ones", "new_full",
    "new_empty", "new_tensor", "expand", "expand_as", "narrow", "permute",
    "clamp", "clamp_", "clamp_min", "clamp_max", "topk", "logical_not",
    "logical_and", "logical_or", "isfinite", "isnan", "isinf", "isin",
    "eq", "ne", "lt", "le", "gt", "ge", "bitwise_and", "bitwise_or",
    "repeat_interleave", "amax", "amin", "argsort", "masked_select",
    "type_as", "flip", "roll", "cumsum", "unbind", "split", "chunk",
    "fill_", "zero_", "copy_", "add_", "mul_", "sub_", "div_",
}

#: calls and methods whose tensor result is boolean (a mask)
BOOL_FNS = {"isfinite", "isnan", "isinf", "isin", "isclose", "logical_not",
            "logical_and", "logical_or", "logical_xor", "eq", "ne", "lt",
            "le", "gt", "ge", "isneginf", "isposinf", "signbit", "bool"}

_STATIC_SUBTREE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                         "layout", "requires_grad", "size", "itemsize"}
_STATIC_SUBTREE_FNS = {"len", "isinstance", "issubclass", "getattr",
                       "hasattr", "callable", "type", "id", "int", "float",
                       "bool", "str", "repr"}


def resolve_call(ctx, node: ast.AST) -> str:
    """Canonical dotted name of a call target, with the module's import
    aliases folded in: ``np.asarray`` -> ``numpy.asarray``, ``F.relu`` ->
    ``torch.nn.functional.relu``."""
    return resolve_name(ctx.imports, node)


def is_tensor_ns(ctx, node: ast.AST) -> bool:
    """Does this call target live under ``torch`` (``torch.nn.functional``
    included) and return a tensor, not metadata?"""
    resolved = resolve_call(ctx, node)
    if not resolved.startswith("torch."):
        return False
    if resolved.startswith(("torch.profiler.", "torch.distributed.",
                            "torch.utils.", "torch.backends.")):
        return False
    return resolved.rsplit(".", 1)[-1] not in METADATA_FNS


def has_ancestor(node: ast.AST, target: ast.AST) -> bool:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if cur is target:
            return True
        cur = getattr(cur, "parent", None)
    return False


_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def enclosing_loop(node: ast.AST) -> Optional[ast.AST]:
    """The nearest loop that runs ``node`` once an iteration: a ``for`` /
    ``while`` body (a ``while`` test too) or a comprehension's element,
    condition or inner iterables. A ``for``'s iterable and ``else`` and a
    comprehension's first iterable run once, so they are not inside it;
    nor is code in a nested function, lambda or class."""
    child, cur = node, getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.For, ast.AsyncFor)):
            if child is not cur.iter and child not in cur.orelse:
                return cur
        elif isinstance(cur, ast.While):
            if child not in cur.orelse:
                return cur
        elif isinstance(cur, ast.comprehension):
            comp = cur.parent
            if child is not cur.iter or cur is not comp.generators[0]:
                return comp
            child, cur = comp, getattr(comp, "parent", None)
            continue
        elif isinstance(cur, _COMPREHENSIONS):
            return cur
        elif isinstance(cur, _FUNC_NODES + (ast.Lambda, ast.ClassDef)):
            return None
        child, cur = cur, getattr(cur, "parent", None)
    return None


def in_traced_loop(ctx, node: ast.AST) -> bool:
    """Does ``node`` run once an iteration of a loop of a ``@traced``
    function (a ``while`` node counts: its test runs every iteration)?"""
    loop = node if isinstance(node, ast.While) else enclosing_loop(node)
    if loop is None:
        return False
    encl = ctx.regions.enclosing_functions(loop)
    return bool(encl) and is_traced_decorated(encl[0])


def is_traced_decorated(fn) -> bool:
    """Does ``fn`` carry the ``@traced("...")`` telemetry decorator?"""
    for deco in fn.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        if dotted_name(target).rsplit(".", 1)[-1] == "traced":
            return True
    return False


def calls_record_span(fn) -> bool:
    """Does the function body record a span itself — ``obs.record_span``
    or its explicit-lineage twin ``obs.tracing.manual_span`` (the
    cross-thread request-lifecycle path, which records the same ring node
    without the contextvar wrapper)?"""
    for node in walk(fn):
        if isinstance(node, ast.Call) and \
                dotted_name(node.func).rsplit(".", 1)[-1] in (
                    "record_span", "manual_span"):
            return True
    return False


def is_obs_enabled_test(ctx, test: ast.AST) -> bool:
    """Is this expression an ``obs.enabled()`` (or alias) call?"""
    return isinstance(test, ast.Call) and \
        resolve_call(ctx, test.func).endswith("obs.enabled")


def under_obs_gate(ctx, node: ast.AST) -> bool:
    """Is ``node`` inside an ``if obs.enabled():`` block?"""
    cur = getattr(node, "parent", None)
    child = node
    while cur is not None:
        if isinstance(cur, ast.If) and is_obs_enabled_test(ctx, cur.test):
            # must be in the THEN branch (the else branch is the off path)
            if any(has_ancestor(child, s) or child is s for s in cur.body):
                return True
        child = cur
        cur = getattr(cur, "parent", None)
    return False


def has_obs_early_return(ctx, fn) -> bool:
    """Does ``fn`` start with ``if not obs.enabled(): return``?"""
    for stmt in fn.body:
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring
        if isinstance(stmt, ast.If) and \
                isinstance(stmt.test, ast.UnaryOp) and \
                isinstance(stmt.test.op, ast.Not) and \
                is_obs_enabled_test(ctx, stmt.test.operand) and \
                any(isinstance(s, ast.Return) for s in stmt.body):
            return True
        return False
    return False


def iter_functions(tree: ast.Module) -> Iterator[ast.AST]:
    for node in walk(tree):
        if isinstance(node, _FUNC_NODES):
            yield node


def _method_name(call: ast.Call) -> str:
    return call.func.attr if isinstance(call.func, ast.Attribute) else ""


def _target_names(tgt):
    return [n.id for n in walk(tgt) if isinstance(n, ast.Name)]


class Taint:
    """Names of one function plausibly bound to tensors (``tensors``), to
    boolean tensors (``masks``) and to host arrays (``host``)."""

    def __init__(self):
        self.tensors, self.masks, self.host = set(), set(), set()


def _is_host_value(ctx, expr) -> bool:
    """A value known to live on the host: a numpy call's result or a
    tensor's host copy."""
    if isinstance(expr, ast.Call):
        if resolve_call(ctx, expr.func).startswith("numpy."):
            return True
        return _method_name(expr) in ("numpy", "tolist", "cpu")
    return False


def _returns(fn):
    """``return`` statements of ``fn`` itself (not of nested functions)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Return):
            yield node
        elif not isinstance(node, _FUNC_NODES + (ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def local_return_tensors(ctx, call: ast.Call, n: int):
    """For a call of a same-module function by bare name: which of its
    ``n`` results are tensors (``n`` = 0: is the whole result one), read
    from its ``return`` statements under its own taint. None when the
    callee is not a local function (or is being analyzed already)."""
    if not isinstance(call.func, ast.Name):
        return None
    fns = ctx.regions.functions_named(call.func.id)
    if not fns:
        return None
    busy = ctx.__dict__.setdefault("_returns_busy", set())
    if any(fn in busy for fn in fns):
        return None
    out = [False] * max(n, 1)
    for fn in fns:
        busy.add(fn)
        try:
            taint = taint_for_function(ctx, fn)
            for ret in _returns(fn):
                val = ret.value
                if val is None:
                    continue
                if n and isinstance(val, (ast.Tuple, ast.List)) and \
                        len(val.elts) == n:
                    for i, elt in enumerate(val.elts):
                        out[i] = out[i] or expr_is_tensor(ctx, elt, taint)
                elif expr_is_tensor(ctx, val, taint):
                    out = [True] * len(out)
        finally:
            busy.discard(fn)
    return out


def taint_for_function(ctx, fn) -> Taint:
    """Names in ``fn`` plausibly bound to tensors: the parameters of a
    function handed to a graph compiler, results of ``torch.*`` calls and
    tensor methods, and anything assigned from those (two propagation
    passes over assignments, for-targets, comprehension targets and
    ``with`` targets — no fixpoint, by design, as in the JAX package).
    Shape/dtype-derived bindings stay untainted (``expr_is_tensor`` prunes
    them), and unpacking a same-module function's tuple taints each name
    by what that function returns in its place."""
    cache = ctx.__dict__.setdefault("_taint_cache", {})
    if fn in cache:
        return cache[fn]
    taint = cache[fn] = Taint()      # a recursive call sees it growing
    if ctx.regions.params_are_tensors(fn):
        a = fn.args
        params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        taint.tensors.update(p for p in params if p != "self")

    def bind(targets, value) -> None:
        names = [n for t in targets for n in _target_names(t)]
        if _is_host_value(ctx, value):
            taint.host.update(names)
            return
        if len(targets) == 1 and isinstance(targets[0], (ast.Tuple, ast.List)) \
                and isinstance(value, ast.Call):
            elts = targets[0].elts
            per = local_return_tensors(ctx, value, len(elts))
            if per is not None:
                for elt, is_tensor in zip(elts, per):
                    if is_tensor:
                        taint.tensors.update(_target_names(elt))
                return
        if expr_is_tensor(ctx, value, taint):
            taint.tensors.update(names)
            if expr_is_mask(ctx, value, taint):
                taint.masks.update(names)

    for _ in range(2):
        for node in walk(fn):
            if isinstance(node, ast.Assign):
                bind(node.targets, node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                bind([node.target], node.value)
            elif isinstance(node, ast.AugAssign):
                if isinstance(node.target, ast.Name) and \
                        expr_is_tensor(ctx, node.value, taint):
                    taint.tensors.add(node.target.id)
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
                if expr_is_tensor(ctx, node.iter, taint):
                    taint.tensors.update(_target_names(node.target))
            elif isinstance(node, ast.withitem):
                if node.optional_vars is not None and \
                        expr_is_tensor(ctx, node.context_expr, taint):
                    taint.tensors.update(_target_names(node.optional_vars))
    return taint


def function_taint(ctx, node: ast.AST) -> Taint:
    """The taint of the innermost function around ``node`` (empty at
    module level)."""
    encl = ctx.regions.enclosing_functions(node)
    return taint_for_function(ctx, encl[0]) if encl else Taint()


def expr_is_tensor(ctx, node: ast.AST, taint: Taint) -> bool:
    """Could this expression hold a tensor? True when it references a
    tainted name, calls into ``torch`` (but for metadata probes) or calls a
    tensor method. Static subtrees are pruned: ``x.shape[0]``, ``len(x)``
    and ``x.item()`` are host values even when ``x`` is a tensor."""
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_SUBTREE_ATTRS:
        return False
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and \
                node.func.id in _STATIC_SUBTREE_FNS:
            return False
        method = _method_name(node)
        if method in HOST_RESULT_METHODS:
            return False
        if is_tensor_ns(ctx, node.func):
            return True
        if resolve_call(ctx, node.func).startswith("torch."):
            return False
        if method in TENSOR_METHODS:
            return not _receiver_on_host(ctx, node, taint)
        if method:
            return expr_is_tensor(ctx, node.func.value, taint)
        per = local_return_tensors(ctx, node, 0)
        if per is not None:
            return per[0]
    if isinstance(node, ast.Name):
        return node.id in taint.tensors
    if isinstance(node, (ast.Constant, ast.JoinedStr, ast.Lambda)):
        return False
    return any(expr_is_tensor(ctx, child, taint)
               for child in ast.iter_child_nodes(node))


def expr_is_mask(ctx, node: ast.AST, taint: Taint) -> bool:
    """Is this a boolean tensor, decidably: a comparison with a tensor
    side, ``~``/``&``/``|`` of masks, a boolean ``torch`` call or method
    (``torch.isfinite(x)``, ``x.eq(y)``), or a name bound to one?"""
    if isinstance(node, ast.Name):
        return node.id in taint.masks
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops):
            return False
        return any(expr_is_tensor(ctx, side, taint)
                   for side in [node.left, *node.comparators])
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return expr_is_mask(ctx, node.operand, taint)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return expr_is_mask(ctx, node.left, taint) or \
            expr_is_mask(ctx, node.right, taint)
    if isinstance(node, ast.Call):
        tail = resolve_call(ctx, node.func).rsplit(".", 1)[-1]
        if is_tensor_ns(ctx, node.func) and tail in BOOL_FNS:
            return True
        method = _method_name(node)
        if method in BOOL_FNS:
            return method in TENSOR_METHODS or \
                expr_is_tensor(ctx, node.func.value, taint)
    return False


def _receiver_on_host(ctx, call: ast.Call, taint: Taint) -> bool:
    recv = call.func.value
    return (isinstance(recv, ast.Name) and recv.id in taint.host) or \
        _is_host_value(ctx, recv)


def _keyword(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_cpu(expr) -> bool:
    return isinstance(expr, ast.Constant) and expr.value == "cpu"


def _from_host(ctx, call: ast.Call, taint: Taint) -> bool:
    """Does ``torch.tensor(src)`` / ``torch.as_tensor(src)`` read host data:
    a literal, a numpy value, or (``torch.tensor`` only, which always
    copies) anything that is not a tensor?"""
    if not call.args:
        return False
    src = call.args[0]
    if isinstance(src, (ast.List, ast.Tuple, ast.ListComp, ast.GeneratorExp)) \
            or _is_host_value(ctx, src) or (
                isinstance(src, ast.Name) and src.id in taint.host):
        return True
    return resolve_call(ctx, call.func) == "torch.tensor" and \
        not expr_is_tensor(ctx, src, taint)


def _h2d_copy(ctx, node: ast.Call, taint: Taint) -> str:
    """A blocking copy of host data to a device (see the module doc)."""
    resolved = resolve_call(ctx, node.func)
    if resolved in ("torch.tensor", "torch.as_tensor"):
        dev = _keyword(node, "device")
        if dev is not None and not _is_cpu(dev) and \
                _from_host(ctx, node, taint):
            return f"{resolved}(host data, device=...)"
        return ""
    recv = node.func.value if isinstance(node.func, ast.Attribute) else None
    if _method_name(node) in ("to", "cuda") and isinstance(recv, ast.Call):
        made = resolve_call(ctx, recv.func)
        on_host = made == "torch.from_numpy" or (
            made in ("torch.tensor", "torch.as_tensor")
            and _is_cpu(_keyword(recv, "device") or ast.Constant("cpu"))
            and _from_host(ctx, recv, taint))
        nb = _keyword(node, "non_blocking")
        if not on_host or (isinstance(nb, ast.Constant) and nb.value is True) \
                or any(_is_cpu(a) for a in node.args):
            return ""
        return f"{made}(...).{_method_name(node)}(device)"
    return ""


def sync_kind(ctx, node: ast.AST, taint: Taint) -> str:
    """'' when ``node`` does not make the host wait for the card; else a
    short label for the message. ``node`` is a Call or a Subscript."""
    if isinstance(node, ast.Subscript):
        if isinstance(node.ctx, ast.Load) and \
                expr_is_mask(ctx, node.slice, taint):
            return "t[mask] (boolean-mask indexing)"
        return ""
    if not isinstance(node, ast.Call):
        return ""
    resolved = resolve_call(ctx, node.func)
    if resolved in HOST_SYNC_CALLS:
        return resolved
    method = _method_name(node)
    if method in HOST_SYNC_ATTRS and not (
            method in ("item", "tolist", "synchronize") and node.args):
        if _receiver_on_host(ctx, node, taint):
            return ""
        return f".{method}()"
    if method == "to" and any(
            isinstance(a, ast.Constant) and a.value == "cpu"
            for a in [*node.args, *(k.value for k in node.keywords)]):
        return ".to('cpu')"
    if method in DATA_SIZED_ATTRS and not node.args:
        if _receiver_on_host(ctx, node, taint):
            return ""
        return f".{method}()"
    copy = _h2d_copy(ctx, node, taint)
    if copy:
        return copy
    if resolved == "torch.where" and len(node.args) == 1:
        return "torch.where(cond)"
    if resolved in HOST_ARRAY_CALLS:
        if node.args and expr_is_tensor(ctx, node.args[0], taint):
            return resolved
        return ""
    if isinstance(node.func, ast.Name) and \
            node.func.id in HOST_SCALAR_CASTS and len(node.args) == 1 and \
            expr_is_tensor(ctx, node.args[0], taint):
        return f"{node.func.id}()"
    return ""
