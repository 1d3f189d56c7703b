"""Encoder factory: the name-keyed facade ``get_encoder``.

Counterpart of ``envidr_tpu/ops/encoders.py``.  Returns ``(encoder,
output_dim)``: the grid encoders (``hashgrid``, ``hashgrid_diff``,
``tiledgrid``, ``rolled_tiled``, ``cp``) are ``nn.Module``s holding their
tables, called as ``encoder(x, bound=...)``; the parameter-free ones
(``None``, ``frequency``, ``sphere_harmonics``, ``integrated_dir``) are
plain functions ``encoder(x, **kw)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from envidr_tpu_torch.models.network import CPEncoder
from envidr_tpu_torch.ops.cp import CPSpec, cp_encode_from_world
from envidr_tpu_torch.ops.freq import freq_encode, freq_output_dim
from envidr_tpu_torch.ops.hashgrid import (
    HashGridSpec, hash_encode_from_world, init_hash_embeddings,
)
from envidr_tpu_torch.ops.ide import ide_encode, ide_output_dim
from envidr_tpu_torch.ops.sh import sh_encode, sh_output_dim

GRID_NAMES = ("hashgrid", "hashgrid_diff", "tiledgrid", "rolled_tiled")


class HashGridEncoder(nn.Module):
    """A hash grid's table ``embeddings`` [table_size, level_dim]; encodes
    world positions in ``[-bound, bound]``."""

    def __init__(self, spec: HashGridSpec, bound: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec, self.bound = spec, bound
        self.embeddings = nn.Parameter(init_hash_embeddings(spec, generator=generator))

    def forward(self, x: torch.Tensor, bound: Optional[float] = None, **kw) -> torch.Tensor:
        return hash_encode_from_world(x, self.embeddings, self.spec,
                                      bound=self.bound if bound is None else bound)


class CPGridEncoder(CPEncoder):
    """The network's CP tables (``axes.<level>.<axis>``, ``proj.<level>``)
    with their spec; encodes world positions in ``[-bound, bound]``."""

    def __init__(self, spec: CPSpec, bound: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(spec, generator)
        self.spec, self.bound = spec, bound

    def forward(self, x: torch.Tensor, bound: Optional[float] = None, **kw) -> torch.Tensor:
        return cp_encode_from_world(x, self.tables(), self.spec,
                                    bound=self.bound if bound is None else bound)


def get_encoder(encoding: str, input_dim: int = 3, multires: int = 6, degree: int = 4,
                num_levels: int = 16, level_dim: int = 2, base_resolution: int = 16,
                log2_hashmap_size: int = 19, desired_resolution: int = 2048,
                bound: float = 1.0, generator: Optional[torch.Generator] = None,
                **kwargs) -> Tuple[Union[nn.Module, Callable], int]:
    """The encoder ``encoding`` names and its output width.  ``generator``
    draws a grid encoder's tables; ``rank`` (``cp``) is the CP rank."""
    if encoding == "None":
        return (lambda x, **kw: x), input_dim
    if encoding == "frequency":
        if multires == 0:
            return (lambda x, **kw: x), input_dim
        return (lambda x, **kw: freq_encode(x, degree=multires)), freq_output_dim(input_dim,
                                                                                  multires)
    if encoding == "sphere_harmonics":
        return (lambda x, **kw: sh_encode(x, degree=degree)), sh_output_dim(degree)
    if encoding == "integrated_dir":
        return ((lambda x, roughness=0.0, **kw: ide_encode(x, roughness, deg_view=degree)),
                ide_output_dim(degree))
    if encoding in GRID_NAMES:
        spec = HashGridSpec(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            interpolation="linear" if encoding in ("hashgrid", "tiledgrid") else "smoothstep",
            indexing="rolled_tiled" if encoding in ("tiledgrid", "rolled_tiled") else "hash")
        return HashGridEncoder(spec, bound, generator), spec.output_dim
    if encoding == "cp":
        spec = CPSpec(input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
                      rank=kwargs.get("rank", 32), base_resolution=base_resolution,
                      desired_resolution=desired_resolution)
        return CPGridEncoder(spec, bound, generator), spec.output_dim
    raise NotImplementedError(
        f"Unknown encoding {encoding!r}; choose from [None, frequency, "
        "sphere_harmonics, integrated_dir, hashgrid, hashgrid_diff, "
        "tiledgrid, rolled_tiled, cp]")
