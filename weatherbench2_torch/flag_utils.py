"""Parsers of ``dim=value`` command-line arguments, without absl.

Counterpart of ``weatherbench2_tpu/flag_utils.py:17-50``, with the same
grammar: ``--input_chunks=time=10,longitude=100`` parses to ``{'time': 10,
'longitude': 100}``; dim=value pairs coerce int, then float, then str.
"""
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
