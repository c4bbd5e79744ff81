"""Self-contained static gate (stdlib-only).

The reference enforces flake8 (max-line-length 119, cognitive-complexity 10)
and mypy (/root/reference/setup.cfg:1-4, requirements-dev.txt:3,13). This
image ships neither tool and installs are not allowed, so this module
implements the same gates with ast/symtable and runs in CI
(tests/tooling/test_static_gates.py). ruff.toml / setup.cfg mirror the rules
for environments that do have the real tools.

Checks:
  * syntax (compile)
  * line length <= 119                         (setup.cfg max-line-length)
  * unused imports (module scope)
  * complexity: branch points per function <= LIMIT, waivable with
    ``# noqa: complexity`` on the def line     (max-cognitive-complexity)
  * no bare ``except:``
  * no tab indentation

Usage: python tools/lint.py [paths...]   (default: placement_tpu/ tools/)
"""

import ast
import pathlib
import sys

MAX_LINE = 119
MAX_BRANCHES = 20

REPO = pathlib.Path(__file__).resolve().parents[1]


def _branches(fn: ast.AST) -> int:
    count = 0
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.For, ast.While, ast.IfExp,
                             ast.ExceptHandler, ast.Assert, ast.With)):
            count += 1
        elif isinstance(node, ast.BoolOp):
            count += len(node.values) - 1
    return count


def _imported_names(node):
    if isinstance(node, ast.Import):
        for a in node.names:
            yield (a.asname or a.name.split(".")[0]), node.lineno
    elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
        for a in node.names:
            if a.name != "*":
                yield (a.asname or a.name), node.lineno


def check_file(path: pathlib.Path):  # noqa: complexity
    errors = []
    rel = path.relative_to(REPO)
    src = path.read_text()
    lines = src.splitlines()

    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [f"{rel}:{e.lineno}: syntax error: {e.msg}"]

    for i, line in enumerate(lines, 1):
        if len(line) > MAX_LINE and "noqa" not in line:
            errors.append(f"{rel}:{i}: line too long ({len(line)} > "
                          f"{MAX_LINE})")
        if line.startswith("\t"):
            errors.append(f"{rel}:{i}: tab indentation")

    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    used |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    for n in ast.walk(tree):
        if isinstance(n, ast.Attribute):
            root = n
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
    exported = set()
    for n in tree.body:
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "__all__"):
            exported = {getattr(e, "value", None) for e in n.value.elts}

    if path.name != "__init__.py":  # __init__ re-export surfaces are exempt
        for name, lineno in (pair for node in tree.body
                             for pair in _imported_names(node)):
            if name not in used and name not in exported:
                errors.append(f"{rel}:{lineno}: unused import '{name}'")

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            line = lines[node.lineno - 1]
            if "noqa" in line:
                continue
            b = _branches(node)
            if b > MAX_BRANCHES:
                errors.append(f"{rel}:{node.lineno}: function "
                              f"'{node.name}' too complex "
                              f"({b} branches > {MAX_BRANCHES})")
        elif isinstance(node, ast.ExceptHandler) and node.type is None:
            errors.append(f"{rel}:{node.lineno}: bare except")
    return errors


def run(paths):
    errors = []
    for p in paths:
        p = pathlib.Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            if "__pycache__" in str(f):
                continue
            errors.extend(check_file(f.resolve()))
    return errors


def main():
    paths = sys.argv[1:] or [REPO / "placement_tpu", REPO / "tools",
                             REPO / "experiments", REPO / "bench.py",
                             REPO / "__graft_entry__.py", REPO / "chip_smoke.py"]
    errors = run(paths)
    for e in errors:
        print(e)
    print(f"{len(errors)} issue(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
