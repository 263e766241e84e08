"""Comms logger: the JAX package's ``comm/logging.py``.

The JAX package records each collective when it is traced; here each one
is recorded when it is issued on a ``torch.distributed`` process group:
op name, wire bytes, the mesh axis it ran over and its participant count.
Bandwidth uses the reference's analytic algbw/busbw formulas
(``calc_bw_log``) on a duration the caller measured.
"""

from collections import defaultdict
from typing import Optional

from ..utils.logging import logger


def get_msg_size_str(size_bytes):
    for unit in ["B", "KB", "MB", "GB", "TB"]:
        if size_bytes < 1024:
            return f"{size_bytes:.2f} {unit}"
        size_bytes /= 1024
    return f"{size_bytes:.2f} PB"


def calc_bw_log(comm_op: str, size_bytes: int, duration_s: float, n: int):
    """Analytic algorithm/bus bandwidth in GB/s (reference
    comms_logging.py:28)."""
    if duration_s <= 0:
        return 0.0, 0.0
    algbw = size_bytes / duration_s
    if comm_op in ("all_gather", "reduce_scatter", "all_to_all"):
        busbw = algbw * ((n - 1) / max(n, 1))
    elif comm_op == "all_reduce":
        busbw = algbw * (2 * (n - 1) / max(n, 1))
    else:
        busbw = algbw
    return algbw / 1e9, busbw / 1e9


class CommsLogger:
    def __init__(self, enabled=False, verbose=False, prof_all=True,
                 debug=False, prof_ops=None):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.debug = debug
        self.prof_ops = prof_ops or []
        # op -> (bytes, axis, participants) -> [count, total bytes]
        self.comms_dict = defaultdict(lambda: defaultdict(lambda: [0, 0]))

    def configure(self, config):
        self.enabled = config.enabled
        self.verbose = config.verbose
        self.prof_all = config.prof_all
        self.debug = config.debug
        self.prof_ops = list(config.prof_ops)

    def append(self, op_name: str, size_bytes: int, axis_name: str,
               participants: int = 0):
        if not self.enabled:
            return
        if self.prof_ops and not self.prof_all and \
                op_name not in self.prof_ops:
            return
        rec = self.comms_dict[op_name][(size_bytes, axis_name, participants)]
        rec[0] += 1
        rec[1] += size_bytes
        if self.verbose:
            logger.info(f"comm op: {op_name} | axis: {axis_name} | "
                        f"participants: {participants} | "
                        f"msg size: {get_msg_size_str(size_bytes)}")

    def log_summary(self):
        if not self.comms_dict:
            logger.info("CommsLogger: no collectives recorded")
            return
        logger.info(f"{'Comm. Op':<16}{'Axis':<10}{'Ranks':<7}"
                    f"{'Message Size':<16}{'Count':<8}{'Total':<14}")
        for op, sizes in self.comms_dict.items():
            for (size, axis, n), (count, total) in sorted(sizes.items()):
                logger.info(f"{op:<16}{axis:<10}{n:<7}"
                            f"{get_msg_size_str(size):<16}{count:<8}"
                            f"{get_msg_size_str(total):<14}")

    def reset(self):
        self.comms_dict.clear()


_COMMS_LOGGER: Optional[CommsLogger] = None


def get_comms_logger() -> CommsLogger:
    global _COMMS_LOGGER
    if _COMMS_LOGGER is None:
        _COMMS_LOGGER = CommsLogger()
    return _COMMS_LOGGER


def configure_comms_logger(config):
    cl = get_comms_logger()
    cl.configure(config)
    return cl
