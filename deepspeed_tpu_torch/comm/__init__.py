from .comm import (ReduceOp, init_distributed, is_initialized, get_rank,
                   get_world_size, get_local_rank, get_backend, barrier,
                   broadcast_object, destroy_process_group, all_reduce,
                   all_gather, all_gather_coalesced, reduce_scatter_coalesced,
                   reduce_scatter, all_to_all, broadcast, ppermute,
                   send_recv_next, send_recv_prev, axis_index, axis_size,
                   log_summary, full_precision,
                   # the reference's names
                   all_gather_into_tensor, allgather_fn,
                   reduce_scatter_tensor, reduce_scatter_fn,
                   all_to_all_single, reduce, gather, scatter, new_group,
                   get_global_rank, monitored_barrier, isend, irecv, send,
                   recv, has_all_gather_into_tensor,
                   has_reduce_scatter_tensor,
                   # accounting
                   comm_stats, comm_per_op_stats, comm_axis_stats,
                   reset_comm_stats)
from .compression import (CommCompressionConfig, configure_comm_compression,
                          get_comm_compression, reset_comm_compression)
from .logging import CommsLogger, get_comms_logger, configure_comms_logger
