"""The plain reference of the 3D FFT configurations: ``torch.fft`` on
whole global arrays, in float64 (complex128), numpy's conventions
(forward unnormalized, backward scaled 1/N), the real transform along
the last axis. It imports nothing of the port.

``forward_lowp`` / ``backward_lowp`` are the control of a float32
configuration: the same transforms with the input and the result of
every axis pass rounded to bfloat16 (each pass's arithmetic in float32),
the step below float32 that would tempt a program."""

from __future__ import annotations

import torch


def forward(x: torch.Tensor, transform: str) -> torch.Tensor:
    x = x.to(torch.complex128 if x.is_complex() else torch.float64)
    if transform == "c2c":
        return torch.fft.fftn(x)
    return torch.fft.rfftn(x)


def backward(y: torch.Tensor, transform: str, shape) -> torch.Tensor:
    y = y.to(torch.complex128)
    if transform == "c2c":
        return torch.fft.ifftn(y)
    return torch.fft.irfftn(y, s=tuple(shape))


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
