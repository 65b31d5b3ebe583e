"""Row-tiling helpers (counterpart of ``raft_tpu/utils/tiling.py``): the
one place the pad/reshape pattern lives, and the OOM-adaptive tile loop.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pad_rows(x: torch.Tensor, multiple: int, fill=0) -> torch.Tensor:
    """Pad axis 0 up to the next multiple (no-op if already aligned)."""
    m = x.shape[0]
    pad = ceil_div(m, multiple) * multiple - m
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                    dtype=x.dtype, device=x.device)])


def pad_and_tile(x: torch.Tensor, tile: int, fill=0
                 ) -> Tuple[torch.Tensor, int]:
    """Pad axis 0 to a multiple of ``tile`` and reshape to
    (n_tiles, tile, *rest). Returns (tiles, n_tiles)."""
    xp = pad_rows(x, tile, fill)
    n_tiles = xp.shape[0] // tile
    return xp.reshape((n_tiles, tile) + tuple(x.shape[1:])), n_tiles


def map_row_tiles(fn: Callable, args: Tuple, tile: int, fills: Tuple = None,
                  min_tile: int = 128):
    """Run ``fn`` over row tiles of several same-leading-dim tensors and
    restitch the row dimension.

    ``fn`` takes a tuple of (tile, ...) blocks and returns a tensor or a
    tuple of tensors with leading dim ``tile``. If the row count fits one
    tile, ``fn`` is called directly. ``fills`` gives the padding value per
    argument (default 0; pass sentinels such as -1 for id arrays).

    The JAX package maps ``fn`` with ``lax.map``; here it is a loop over
    the tiles. The tile size is OOM-adaptive: an OOM-classified failure
    retries the whole map at half the tile, down to ``min_tile``
    (``resilience.degrade_on_oom``), each attempt forced to completion so a
    failure of queued work is caught there."""
    n = args[0].shape[0]
    if tile >= n:
        return fn(args)
    fills = fills or (0,) * len(args)

    def run(tile):
        tiled = [pad_and_tile(a, tile, fill)[0]
                 for a, fill in zip(args, fills)]
        outs = [fn(tuple(t[i] for t in tiled)) for i in range(tiled[0].shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[j] for o in outs])[:n]
                         for j in range(len(outs[0])))
        return torch.cat(outs)[:n]

    from raft_tpu_torch.resilience import degrade_on_oom, force_completion

    return degrade_on_oom(lambda t: force_completion(run(t)), tile,
                          floor=min(int(tile), max(1, int(min_tile))),
                          site="tiling.map_row_tiles")
