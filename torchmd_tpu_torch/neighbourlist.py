"""Reference-name alias for the neighbour-list utilities.

The reference ships `torchmd/neighbourlist.py` as an unused sketch. Here
the functionality lives in `torchmd_tpu_torch.neighbors`; this module
keeps the reference spelling importable. (The JAX package's
`candidate_matrix` and `discretize_box` belong to its Verlet path, which
the port does not have yet.)
"""

from .neighbors import (
    CellKernel,
    CellList,
    CellListConfig,
    build_cell_list,
    make_cell_config,
    needs_rebuild,
)

__all__ = [
    "CellKernel", "CellList", "CellListConfig", "build_cell_list",
    "make_cell_config", "needs_rebuild",
]
