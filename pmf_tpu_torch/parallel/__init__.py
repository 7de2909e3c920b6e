from . import spatial
from .collectives import (average_gradients, barrier, broadcast_state, col_layout, data_parallel,
                          gather_cols, global_count, global_sum, global_sum_count, own_cols,
                          rand_rows)
from .mesh import Mesh, check_mesh, init_distributed, make_mesh, shutdown, world
