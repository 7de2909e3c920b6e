from .collectives import (average_gradients, barrier, broadcast_state, data_parallel,
                          gather_cols, global_count, global_sum, own_cols, rand_rows)
from .mesh import check_mesh, init_distributed, shutdown, world
