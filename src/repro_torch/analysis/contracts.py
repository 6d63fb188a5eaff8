"""Registry contract audit of the port: metadata vocabulary + ``handle_dangling``
flow (the reference's ``repro.analysis.contracts``, aimed at
:mod:`repro_torch.core.solver`).

Two contracts, both decidable without running anything:

1. **Metadata** — every registered variant's ``description`` / ``layout`` /
   ``backend`` / ``schedule`` must satisfy the closed vocabularies the
   generic drivers dispatch on (``BACKENDS`` = numpy, torch, cuda;
   ``SCHEDULES`` = barrier, nosync, adaptive, sequential).
   ``register_variant`` raises at import time, and this pass re-audits the
   live registry against the same sets — a belt-and-braces check that also
   covers registrations made by monkeypatching tests or future refactors
   of the constructor.

2. **Dangling flow** — a variant that *accepts* ``handle_dangling`` and
   silently drops it converges to the wrong fixed point on any graph with
   sinks.  That bug class is mechanized here by AST inspection of each
   variant's ``run``: the flag must be able to *reach* the sweep — either
   as an explicit parameter that the body actually reads, or through a
   ``**kw`` catch-all that is forwarded (``f(**kw)``) or passed to a filter
   helper whose source names the flag (the registry's ``_run_kw(kw)``
   idiom).  A ``run`` whose signature cannot receive the flag, or that
   receives and ignores it, is a finding.

The audit inspects *source*, so it sees lambdas registered inline: the
lambda's AST node is recovered from the enclosing statement by matching its
argument names against the compiled code object.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable

from repro_torch.analysis.findings import Finding

_CO_VARKEYWORDS = 0x08  # CodeType.co_flags bit for a **kwargs parameter

FLAG = "handle_dangling"


def _source_tree(fn: Callable):
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return None
    try:
        return ast.parse(src)
    except SyntaxError:
        return None


def _fn_node(fn: Callable):
    """The FunctionDef/Lambda AST node of ``fn``.

    Named functions match by name.  Lambdas (typically inline in a
    ``register_variant`` call that also holds a ``build`` lambda) match by
    their positional-argument names and ``**kwargs`` presence against
    ``fn.__code__`` — the registry's ``build``/``run`` lambda pairs differ
    in both, so the match is unambiguous.
    """
    tree = _source_tree(fn)
    if tree is None:
        return None
    code = fn.__code__
    if fn.__name__ != "<lambda>":
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == fn.__name__:
                return node
        return None
    want_pos = list(code.co_varnames[: code.co_argcount])
    want_kwarg = bool(code.co_flags & _CO_VARKEYWORDS)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Lambda):
            continue
        pos = [a.arg for a in node.args.posonlyargs + node.args.args]
        if pos == want_pos and (node.args.kwarg is not None) == want_kwarg:
            return node
    return None


def _resolve(func_node, fn: Callable):
    """Resolve a called name to the function object it refers to, looking
    through ``fn``'s globals and closure (for helpers like ``_run_kw``)."""
    if not isinstance(func_node, ast.Name):
        return None
    name = func_node.id
    if fn.__closure__ and fn.__code__.co_freevars:
        for var, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            if var == name:
                try:
                    return cell.cell_contents
                except ValueError:
                    return None
    return getattr(fn, "__globals__", {}).get(name)


def _mentions_dangling(fn: Callable) -> bool:
    try:
        return FLAG in inspect.getsource(fn)
    except (OSError, TypeError):
        return False


def audit_dangling_flow(run: Callable, *, target: str) -> list[Finding]:
    """Findings for one ``run`` callable's ``handle_dangling`` plumbing."""
    node = _fn_node(run)
    if node is None:
        return [Finding(
            "contracts", target, "dangling-flow",
            "run source is unavailable for AST inspection — register a "
            "def/lambda whose source importlib can see",
        )]
    params = [a.arg for a in (node.args.posonlyargs + node.args.args
                              + node.args.kwonlyargs)]
    body_nodes = list(ast.walk(node))

    if FLAG in params:
        used = any(isinstance(n, ast.Name) and n.id == FLAG
                   and isinstance(n.ctx, ast.Load) for n in body_nodes)
        if used:
            return []
        return [Finding(
            "contracts", target, "dangling-flow",
            f"run accepts {FLAG} but its body never reads it — the flag is "
            f"silently dropped (wrong fixed point on any graph with sinks)",
        )]

    if node.args.kwarg is not None:
        kwname = node.args.kwarg.arg
        for call in (n for n in body_nodes if isinstance(n, ast.Call)):
            for kw in call.keywords:  # f(**kw) — wholesale forward
                if kw.arg is None and isinstance(kw.value, ast.Name) \
                        and kw.value.id == kwname:
                    return []
            for a in call.args:  # helper(kw) — e.g. _run_kw(kw)
                if isinstance(a, ast.Name) and a.id == kwname:
                    helper = _resolve(call.func, run)
                    if helper is not None and _mentions_dangling(helper):
                        return []
        return [Finding(
            "contracts", target, "dangling-flow",
            f"run only receives {FLAG} through **{kwname} but never "
            f"forwards it (no `**{kwname}` call-through, no filter helper "
            f"naming the flag) — the flag is silently dropped",
        )]

    return [Finding(
        "contracts", target, "dangling-flow",
        f"run signature ({', '.join(params) or 'no params'}) cannot receive "
        f"{FLAG} at all — solve_variant passes it to every variant",
    )]


def audit_metadata(variant) -> list[Finding]:
    """Re-audit one variant's metadata against the registry vocabularies
    (``register_variant`` enforces the same sets at import time)."""
    from repro_torch.core.solver import BACKENDS, SCHEDULES

    out = []

    def bad(check, msg):
        out.append(Finding("contracts", variant.name, check, msg))

    if not variant.description:
        bad("metadata-empty", "description is empty (printed by --list)")
    if not variant.layout:
        bad("metadata-empty", "layout is empty (bundle-sharing key)")
    if variant.backend not in BACKENDS:
        bad("metadata-vocabulary",
            f"backend {variant.backend!r} not in {sorted(BACKENDS)}")
    if variant.schedule not in SCHEDULES:
        bad("metadata-vocabulary",
            f"schedule {variant.schedule!r} not in {sorted(SCHEDULES)}")
    return out


def audit_variant(variant) -> list[Finding]:
    return (audit_metadata(variant)
            + audit_dangling_flow(variant.run, target=variant.name))


def audit_registry() -> dict[str, list[Finding]]:
    """Per-variant audit of the whole registry — the launcher's ``--list``
    ✓/flag column reads this."""
    from repro_torch.core.solver import get_variant, list_variants

    return {name: audit_variant(get_variant(name)) for name in list_variants()}


def contract_findings() -> list[Finding]:
    return [f for fs in audit_registry().values() for f in fs]
