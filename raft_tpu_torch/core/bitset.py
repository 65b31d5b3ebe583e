"""Packed bitset for search prefiltering (counterpart of
``raft_tpu/core/bitset.py``).

Bit ``i`` of word ``w`` is id ``32·w + i``, the JAX package's layout. The
words are stored as int32 holding the same 32 bits as the JAX package's
uint32 words (torch's uint32 has few ops): every read widens a word to
int64 and masks it to its low 32 bits, so bit 31 never sign-extends into a
pass. :meth:`Bitset.from_numpy_words` and :meth:`Bitset.numpy_words`
carry words across the two packages unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import DeviceLike, resolve_device

_LOW32 = 0xFFFFFFFF


def _as_int32_words(words64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 tensors with the same 32 bits."""
    return torch.where(words64 >= (1 << 31), words64 - (1 << 32),
                       words64).to(torch.int32)


def _as_mask_tensor(mask, device: Optional[DeviceLike]) -> torch.Tensor:
    """A 1-d bool tensor: tensors keep their device, anything else goes to
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    if isinstance(mask, torch.Tensor):
        return mask.reshape(-1).to(torch.bool)
    arr = np.asarray(mask).reshape(-1).astype(bool)
    return torch.from_numpy(arr).to(resolve_device(device))


@dataclass
class Bitset:
    """Fixed-size bitset over ``[0, n_bits)``: ``bits`` (ceil(n_bits/32),)
    int32 words."""

    bits: torch.Tensor
    n_bits: int
    _pass_rate_cache: Optional[float] = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.bits.device

    @classmethod
    def create(cls, n_bits: int, default: bool = True,
               device: Optional[DeviceLike] = None) -> "Bitset":
        """Every bit set (``default``) or clear. Set words fill the last
        word's tail bits past ``n_bits`` too, as the JAX package does."""
        n_words = (int(n_bits) + 31) // 32
        return cls(torch.full((n_words,), -1 if default else 0,
                              dtype=torch.int32,
                              device=resolve_device(device)), int(n_bits))

    @classmethod
    def from_mask(cls, mask, device: Optional[DeviceLike] = None) -> "Bitset":
        """Build from a boolean vector (True = keep)."""
        m = _as_mask_tensor(mask, device)
        n_bits = m.shape[0]
        n_words = (n_bits + 31) // 32
        padded = torch.nn.functional.pad(m.to(torch.int64),
                                         (0, n_words * 32 - n_bits))
        weights = torch.ones(32, dtype=torch.int64, device=m.device) \
            << torch.arange(32, device=m.device)
        words = (padded.reshape(n_words, 32) * weights).sum(dim=1)
        return cls(_as_int32_words(words), n_bits)

    @classmethod
    def from_numpy_words(cls, words, n_bits: int,
                         device: Optional[DeviceLike] = None) -> "Bitset":
        """The JAX package's ``(bits uint32, n_bits)`` as numpy."""
        w = np.ascontiguousarray(np.asarray(words, np.uint32)).view(np.int32)
        return cls(torch.from_numpy(w.copy()).to(resolve_device(device)),
                   int(n_bits))

    def numpy_words(self) -> np.ndarray:
        """The words as the JAX package holds them (uint32)."""
        return self.bits.cpu().numpy().view(np.uint32)

    def to(self, device: DeviceLike) -> "Bitset":
        return Bitset(self.bits.to(torch.device(device)), self.n_bits,
                      self._pass_rate_cache)

    def _words(self, device: torch.device) -> torch.Tensor:
        """The words as unsigned values in int64, on ``device``."""
        return self.bits.to(device).to(torch.int64) & _LOW32

    def test(self, ids: torch.Tensor) -> torch.Tensor:
        """Vectorised membership test; negative and out-of-range ids fail."""
        ids = torch.as_tensor(ids).to(torch.int64)
        words = self._words(ids.device)
        word = words[torch.clamp(torch.div(ids, 32, rounding_mode="floor"),
                                 0, words.shape[0] - 1)]
        bit = (word >> torch.remainder(ids, 32)) & 1
        return (bit == 1) & (ids >= 0) & (ids < self.n_bits)

    def set(self, ids, value: bool = True) -> "Bitset":
        """A new bitset with ``ids`` set (or cleared). Duplicates are fine;
        ids in ``[-n_bits, 0)`` count from the end and the rest of the
        out-of-range ids are dropped, as the JAX package's scatter does."""
        ids = torch.as_tensor(ids, device=self.device).to(torch.int64)
        ids = ids.reshape(-1)
        ids = torch.where(ids < 0, ids + self.n_bits, ids)
        ids = ids[(ids >= 0) & (ids < self.n_bits)]
        touched = torch.zeros(self.n_bits, dtype=torch.bool,
                              device=self.device)
        touched[ids] = True
        packed = Bitset.from_mask(touched).bits
        bits = (self.bits | packed) if value else (self.bits & ~packed)
        return Bitset(bits, self.n_bits)

    def to_mask(self) -> torch.Tensor:
        shifts = torch.arange(32, device=self.device)
        bits = (self._words(self.device)[:, None] >> shifts) & 1
        return bits.reshape(-1)[:self.n_bits].to(torch.bool)

    def count(self) -> torch.Tensor:
        return self.to_mask().sum()

    def popcount(self) -> torch.Tensor:
        """Set bits in ``[0, n_bits)``, SWAR over the words; the tail bits
        ``create(default=True)`` sets past ``n_bits`` are masked off."""
        x = self._words(self.device)
        tail = self.n_bits % 32
        if tail and x.shape[0]:
            x = x.clone()
            x[-1] &= (1 << tail) - 1
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        return (((x * 0x01010101) & _LOW32) >> 24).sum()

    def pass_rate(self) -> float:
        """Fraction of ids in ``[0, n_bits)`` that pass: a host float,
        cached on the instance (one device sync per bitset)."""
        if self._pass_rate_cache is None:
            self._pass_rate_cache = float(self.popcount()) / float(
                max(1, self.n_bits))
        return self._pass_rate_cache
