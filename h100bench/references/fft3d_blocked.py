"""The plain reference of the 3D FFT configurations whose grid is too
large for ``fft3d.py`` beside the check's other arrays on one card:
``torch.fft`` in float64 (complex128), numpy's conventions (forward
unnormalized, backward scaled 1/N), the real transform along the last
axis, computed in blocks. It imports nothing of the port.

``forward`` and ``backward`` copy the input into one complex128 buffer
block by block and transform it one axis at a time, each block written
back in place: the trailing plane (axes 1 and 2) a block of planes along
axis 0 at a time, axis 0 a block along axis 1 at a time. A block holds at
most :data:`BLOCK_BYTES` of complex128, so the temporaries beside the
buffer are a few blocks, not whole arrays.

One departure from ``fft3d.py``: the result is rounded once, at the end,
to complex64 (the real backward result to float32), so that the check's
differences run in complex64. At 1024^3 the two kept pairs (32 GiB), the
field (8 GiB) and a complex128 spectrum with its complex128 copies and
differences would pass the card's 80 GB; stored in complex64 the check
stays under about 72 GiB. The rounding adds at most 2^-24 of a value,
under 4e-7 of the spectrum's root mean square even at its largest bin:
three orders of magnitude under a 5e-4 limit.

``forward_lowp`` / ``backward_lowp`` are ``fft3d.py``'s control of a
float32 configuration: the same transforms with the input and the result
of every axis pass rounded to bfloat16 (each pass's arithmetic in
float32), the step below float32 that would tempt a program."""

from __future__ import annotations

import torch

#: Complex128 bytes of one block of the buffer.
BLOCK_BYTES = 1 << 29


def _step(per_index: int, block: int | None) -> int:
    """Indices of a block along the walked axis whose other axes hold
    ``per_index`` elements: ``block`` where given (the tests' small
    blocks), else as many as :data:`BLOCK_BYTES` holds."""
    return block or max(1, BLOCK_BYTES // (16 * per_index))


def _axis0(buf: torch.Tensor, forward: bool, block: int | None) -> None:
    """The transform along axis 0 of ``buf``, in place, a block along
    axis 1 at a time."""
    fft = torch.fft.fft if forward else torch.fft.ifft
    n0, n1, m2 = buf.shape
    b = _step(n0 * m2, block)
    for j in range(0, n1, b):
        buf[:, j:j + b] = fft(buf[:, j:j + b], dim=0)


def _rounded(buf: torch.Tensor, dtype: torch.dtype,
             block: int | None) -> torch.Tensor:
    out = torch.empty(buf.shape, dtype=dtype, device=buf.device)
    b = _step(buf[0].numel(), block)
    for i in range(0, buf.shape[0], b):
        out[i:i + b] = buf[i:i + b]
    return out


def forward(x: torch.Tensor, transform: str,
            block: int | None = None) -> torch.Tensor:
    n0, n1, n2 = x.shape
    c2c = transform == "c2c"
    buf = torch.empty((n0, n1, n2 if c2c else n2 // 2 + 1),
                      dtype=torch.complex128, device=x.device)
    b = _step(n1 * n2, block)
    for i in range(0, n0, b):
        if c2c:
            buf[i:i + b] = x[i:i + b]
            buf[i:i + b] = torch.fft.fft2(buf[i:i + b])
        else:
            buf[i:i + b] = torch.fft.rfft2(x[i:i + b].to(torch.float64))
    _axis0(buf, True, block)
    return _rounded(buf, torch.complex64, block)


def backward(y: torch.Tensor, transform: str, shape,
             block: int | None = None) -> torch.Tensor:
    n0, n1, n2 = (int(s) for s in shape)
    buf = torch.empty(y.shape, dtype=torch.complex128, device=y.device)
    b = _step(y[0].numel(), block)
    for i in range(0, n0, b):
        buf[i:i + b] = y[i:i + b]
    _axis0(buf, False, block)
    if transform == "c2c":
        for i in range(0, n0, b):
            buf[i:i + b] = torch.fft.ifft2(buf[i:i + b])
        return _rounded(buf, torch.complex64, block)
    out = torch.empty((n0, n1, n2), dtype=torch.float32, device=y.device)
    for i in range(0, n0, b):
        out[i:i + b] = torch.fft.irfft2(buf[i:i + b], s=(n1, n2))
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        r = torch.view_as_real(x).to(torch.bfloat16).to(torch.float32)
        return torch.view_as_complex(r.contiguous())
    return x.to(torch.bfloat16).to(torch.float32)


def forward_lowp(x: torch.Tensor, transform: str) -> torch.Tensor:
    x = _bf16(x)
    if transform == "c2c":
        x = _bf16(torch.fft.fft(x, dim=2))
    else:
        x = _bf16(torch.fft.rfft(x, dim=2))
    x = _bf16(torch.fft.fft(x, dim=1))
    return _bf16(torch.fft.fft(x, dim=0)).to(torch.complex64)


def backward_lowp(y: torch.Tensor, transform: str, shape) -> torch.Tensor:
    y = _bf16(y.to(torch.complex64))
    y = _bf16(torch.fft.ifft(y, dim=0))
    y = _bf16(torch.fft.ifft(y, dim=1))
    if transform == "c2c":
        return _bf16(torch.fft.ifft(y, dim=2)).to(torch.complex64)
    return _bf16(torch.fft.irfft(y, n=int(shape[2]), dim=2))
