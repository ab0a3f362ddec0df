"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""
import ast
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "weatherbench2_tpu"}
PROGRAM = "weatherbench2_torch"


def _top_level_imports(path):
  names = set()
  for node in ast.walk(ast.parse(path.read_text(), str(path))):
    if isinstance(node, ast.Import):
      names.update(a.name.split(".")[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      names.add(node.module.split(".")[0])
  return names


def test_no_jax_anywhere():
  files = sorted(BENCH.rglob("*.py"))
  assert files
  for path in files:
    assert not _top_level_imports(path) & NEVER, path


def test_reference_imports_nothing_of_the_program():
  files = sorted((BENCH / "reference").glob("*.py"))
  assert files
  for path in files:
    assert PROGRAM not in _top_level_imports(path), path


def test_whole_names_are_compared():
  # a module named like the port is not the JAX package, and the reverse
  assert "weatherbench2_torch".split(".")[0] not in NEVER
  assert "weatherbench2_tpu.xds".split(".")[0] in NEVER
