"""Command-line flags of the port's CLIs, without absl.

Counterpart of ``weatherbench2_tpu/flag_utils.py``, with the same grammar:
``--input_chunks=time=10,longitude=100`` parses to ``{'time': 10,
'longitude': 100}``; dim=value pairs coerce int, then float, then str.
``Flags`` defines absl-style flags on argparse, so that the port's CLIs take
the command lines of the JAX package's scripts.
"""
import argparse
import re
from typing import Union

DimValueType = Union[int, float, str]

_CHUNKS_RE = re.compile(r"(\w+=-?\d+(,\w+=-?\d+)*)?")


def parse_chunks(chunks_string: str) -> dict:
  """Parse 'dim=size,dim=size' into {dim: int}."""
  if re.fullmatch(_CHUNKS_RE, chunks_string) is None:
    raise ValueError(f"invalid chunks string: {chunks_string}")
  chunks = {}
  if chunks_string:
    for entry in chunks_string.split(","):
      key, value = entry.split("=")
      chunks[key] = int(value)
  return chunks


def get_dim_value(value_string: str) -> DimValueType:
  """Coerce a string to int, then float, falling back to str."""
  value_string = str(value_string)
  try:
    return int(value_string)
  except ValueError:
    pass
  try:
    return float(value_string)
  except ValueError:
    pass
  return value_string


def parse_dim_value_pairs(dim_value_string: str) -> dict:
  """Parse 'dim=value,...' with int/float/str coercion."""
  pairs = {}
  if dim_value_string:
    for entry in dim_value_string.split(","):
      key, value = entry.split("=")
      pairs[key] = get_dim_value(value)
  return pairs


def _bool(value: str) -> bool:
  if value.lower() in ("true", "t", "1", "yes", "y"):
    return True
  if value.lower() in ("false", "f", "0", "no", "n"):
    return False
  raise argparse.ArgumentTypeError(f"not a boolean: {value!r}")


def _list(value: str) -> list:
  return [v for v in value.split(",") if v]


class Flags:
  """absl-style flags on an argparse parser: ``--name=value``; booleans
  also take ``--name`` and ``--noname``; lists are comma-separated."""

  def __init__(self, prog: str, doc: str):
    self.parser = argparse.ArgumentParser(
        prog=prog, description=doc, allow_abbrev=False,
        formatter_class=argparse.RawDescriptionHelpFormatter)

  def string(self, name, default, help):  # pylint: disable=redefined-builtin
    self.parser.add_argument(f"--{name}", default=default, help=help)

  def integer(self, name, default, help):  # pylint: disable=redefined-builtin
    self.parser.add_argument(f"--{name}", type=int, default=default,
                             help=help)

  def boolean(self, name, default, help):  # pylint: disable=redefined-builtin
    self.parser.add_argument(f"--{name}", type=_bool, nargs="?", const=True,
                             default=default, help=help)
    self.parser.add_argument(f"--no{name}", dest=name, action="store_false",
                             help=argparse.SUPPRESS)

  def listing(self, name, default, help):  # pylint: disable=redefined-builtin
    self.parser.add_argument(f"--{name}", type=_list, default=default,
                             help=help)

  def chunks(self, name, default, help):  # pylint: disable=redefined-builtin
    self.parser.add_argument(f"--{name}", type=parse_chunks,
                             default=parse_chunks(default), help=help)

  def dim_value_pairs(self, name, default, help):  # pylint: disable=redefined-builtin
    self.parser.add_argument(f"--{name}", type=parse_dim_value_pairs,
                             default=parse_dim_value_pairs(default),
                             help=help)

  def device(self):
    self.string("device", None,
                'Where to run: the CUDA card when not given, or "cpu".')
