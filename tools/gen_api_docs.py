"""Generate markdown API docs for nextsimdg_tpu from docstrings.

The reference ships generated API documentation (Sphinx + Doxygen via
`.github/workflows/doxygen.yml:25-42`); this is the dependency-free
equivalent: walk every module in the package with ``inspect``, emit one
markdown file per module (module docstring, public classes with method
signatures + docstrings, public functions), plus an index. Run:

    python tools/gen_api_docs.py [out_dir]

CI regenerates the docs and fails if they drift from the committed tree
(so the committed docs always match the code).
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# Docs build on the CPU backend.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import nextsimdg_tpu  # noqa: E402


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    doc = inspect.getdoc(obj)
    return doc.strip() if doc else ""


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def document_module(mod) -> str:
    lines = [f"# `{mod.__name__}`", ""]
    if _doc(mod):
        lines += [_doc(mod), ""]

    classes = []
    functions = []
    for name, obj in sorted(vars(mod).items()):
        if not _is_public(name):
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            continue  # re-exports documented where they are defined
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif inspect.isfunction(obj):
            functions.append((name, obj))

    for name, cls in classes:
        lines += [f"## class `{name}`", ""]
        if _doc(cls):
            lines += [_doc(cls), ""]
        for mname, meth in sorted(vars(cls).items()):
            if not _is_public(mname):
                continue
            target = None
            prefix = ""
            if isinstance(meth, (staticmethod, classmethod)):
                target = meth.__func__
                prefix = "static " if isinstance(meth, staticmethod) else "class "
            elif isinstance(meth, property):
                lines += [f"### property `{mname}`", ""]
                if _doc(meth):
                    lines += [_doc(meth), ""]
                continue
            elif inspect.isfunction(meth):
                target = meth
            elif hasattr(meth, "__wrapped__") and inspect.isfunction(meth.__wrapped__):
                target = meth.__wrapped__  # functools.partial(jax.jit, ...)
            if target is None:
                continue
            lines += [f"### {prefix}`{mname}{_signature(target)}`", ""]
            if _doc(target):
                lines += [_doc(target), ""]

    for name, fn in functions:
        lines += [f"## `{name}{_signature(fn)}`", ""]
        if _doc(fn):
            lines += [_doc(fn), ""]

    return "\n".join(lines).rstrip() + "\n"


def main(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    # Reconcile against deleted/renamed modules: every .md here is
    # generated, so clear them first (otherwise orphaned pages survive the
    # CI freshness check forever — regeneration never touches them).
    for name in os.listdir(out_dir):
        if name.endswith(".md"):
            os.unlink(os.path.join(out_dir, name))
    written = []
    for info in pkgutil.walk_packages(
        nextsimdg_tpu.__path__, prefix="nextsimdg_tpu."
    ):
        if info.name.endswith("__main__"):
            continue  # CLI entry shims have import side effects
        try:
            mod = importlib.import_module(info.name)
        except Exception as exc:  # optional deps (e.g. netCDF tooling)
            print(f"skip {info.name}: {exc}", file=sys.stderr)
            continue
        text = document_module(mod)
        fname = info.name.replace(".", "_") + ".md"
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(text)
        written.append((info.name, fname))

    with open(os.path.join(out_dir, "index.md"), "w") as f:
        f.write("# nextsimdg_tpu API reference\n\n")
        f.write("Generated by `tools/gen_api_docs.py` (CI keeps it fresh).\n\n")
        for name, fname in sorted(written):
            mod = importlib.import_module(name)
            first = (_doc(mod).splitlines() or [""])[0]
            f.write(f"- [`{name}`]({fname}) — {first}\n")
    print(f"wrote {len(written)} module docs to {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "docs/api")
