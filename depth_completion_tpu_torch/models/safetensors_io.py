"""Read and write ``.safetensors`` files with torch and the standard library.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor's name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the data that follows the header; an optional
``"__metadata__"`` entry of strings), then the raw little-endian buffers.
The port reads checkpoints with this module because the card's machine has
no ``safetensors`` package; ``save_file`` writes what
``safetensors.numpy.load_file`` and ``safetensors.torch.load_file`` read.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,  # transformers' position_ids buffer
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one file, on the CPU, in the file's dtype. Raises
    ``ValueError`` on a dtype outside ``DTYPES``, a header that does not
    parse, or a buffer that overruns the file or disagrees with its shape."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        n = int.from_bytes(head, "little")
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes overruns the file ({size} bytes)")
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise ValueError(f"{path}: header is not JSON ({e})") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: header is not a JSON object")
        data_size = size - 8 - n
        entries = sorted(((k, v) for k, v in header.items() if k != "__metadata__"),
                         key=lambda kv: kv[1]["data_offsets"][0])
        out: dict[str, torch.Tensor] = {}
        for name, info in entries:
            dtype = DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not one of "
                                 f"{sorted(DTYPES)}")
            shape = tuple(int(d) for d in info["shape"])
            begin, end = (int(x) for x in info["data_offsets"])
            if not 0 <= begin <= end <= data_size:
                raise ValueError(f"{path}: {name} spans bytes [{begin}, {end}) of a "
                                 f"{data_size}-byte buffer")
            nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            if end - begin != nbytes:
                raise ValueError(f"{path}: {name} holds {end - begin} bytes, its shape "
                                 f"{shape} in {info['dtype']} needs {nbytes}")
            if nbytes == 0:
                out[name] = torch.empty(shape, dtype=dtype)
                continue
            f.seek(8 + n + begin)
            raw = bytearray(nbytes)
            if f.readinto(raw) != nbytes:
                raise ValueError(f"{path}: {name} is cut short")
            out[name] = torch.frombuffer(raw, dtype=dtype).reshape(shape)
    return out


def load_dir(path: str | Path) -> dict[str, torch.Tensor]:
    """Every ``*.safetensors`` file under ``path``, merged."""
    files = sorted(Path(path).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files under {path}")
    state: dict[str, torch.Tensor] = {}
    for f in files:
        state.update(load_file(f))
    return state


def save_file(state: dict[str, torch.Tensor], path: str | Path) -> int:
    """Write ``state`` (name → tensor, any device) to ``path`` → the bytes
    written. Buffers follow the header in name order."""
    tensors = {}
    for name in sorted(state):
        t = state[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} cannot be written")
        tensors[name] = t.detach().contiguous().cpu()
    header: dict = {}
    offset = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the buffers start 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset
