"""LR schedules: a copy of the JAX package's ``runtime/lr_schedules.py``
(pure Python). Each schedule is a ``step -> lr`` callable with the torch
scheduler API (``step()``, ``get_last_lr()``); the engine reads the lr on
the host before each step.
"""

import math

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      WARMUP_COSINE_LR]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


class _BaseSchedule:
    """step()/get_last_lr() API like torch schedulers + __call__(step)->lr."""

    def __init__(self):
        self.last_batch_iteration = -1

    def get_lr_at(self, step: int) -> float:
        raise NotImplementedError

    def __call__(self, step):
        return self.get_lr_at(int(step))

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        return [self.get_lr_at(max(self.last_batch_iteration, 0))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(_BaseSchedule):
    """reference lr_schedules.py:626."""

    def __init__(self, optimizer=None, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE,
                 last_batch_iteration=-1):
        super().__init__()
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        self.last_batch_iteration = last_batch_iteration

    def _warmup_ratio(self, step):
        if step < self.warmup_num_steps:
            if self.warmup_type == WARMUP_LOG_RATE:
                return self.inverse_log_warm_up * math.log(step + 1)
            return step / self.warmup_num_steps
        return 1.0

    def get_lr_at(self, step):
        gamma = self._warmup_ratio(step)
        return self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * gamma


class WarmupDecayLR(WarmupLR):
    """warmup then linear decay to 0 over total_num_steps
    (reference lr_schedules.py:715)."""

    def __init__(self, optimizer=None, total_num_steps=10000, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000,
                 warmup_type=WARMUP_LOG_RATE, last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr,
                         warmup_num_steps, warmup_type, last_batch_iteration)

    def _warmup_ratio(self, step):
        if step < self.warmup_num_steps:
            return super()._warmup_ratio(step)
        return max(
            0.0,
            (self.total_num_steps - step) /
            max(1.0, self.total_num_steps - self.warmup_num_steps))


class WarmupCosineLR(WarmupLR):
    """warmup then cosine decay to cos_min_ratio (later-reference parity)."""

    def __init__(self, optimizer=None, total_num_steps=10000, warmup_min_ratio=0.0,
                 warmup_num_steps=1000, cos_min_ratio=0.0001,
                 warmup_type=WARMUP_LINEAR_RATE, warmup_max_lr=0.001,
                 last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        self.cos_min_ratio = cos_min_ratio
        super().__init__(optimizer, warmup_min_ratio * warmup_max_lr,
                         warmup_max_lr, warmup_num_steps, warmup_type,
                         last_batch_iteration)

    def _warmup_ratio(self, step):
        if step < self.warmup_num_steps:
            return super()._warmup_ratio(step)
        progress = min(
            1.0, (step - self.warmup_num_steps) /
            max(1.0, self.total_num_steps - self.warmup_num_steps))
        cos = 0.5 * (1 + math.cos(math.pi * progress))
        return self.cos_min_ratio + (1 - self.cos_min_ratio) * cos


class LRRangeTest(_BaseSchedule):
    """LR sweep for tuning (reference lr_schedules.py:258)."""

    def __init__(self, optimizer=None, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__()
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.last_batch_iteration = last_batch_iteration

    def get_lr_at(self, step):
        if self.staircase:
            interval = float(step // self.step_size)
        else:
            interval = step / self.step_size
        return self.min_lr * (1 + self.step_rate * interval)


class OneCycle(_BaseSchedule):
    """1cycle policy (reference lr_schedules.py:361). Momentum cycling values
    are computed and exposed via get_mom() for optimizers that consume them."""

    def __init__(self, optimizer=None, cycle_min_lr=0.0001, cycle_max_lr=0.01,
                 decay_lr_rate=0.0, cycle_first_step_size=2000,
                 cycle_second_step_size=None, cycle_first_stair_count=0,
                 cycle_second_stair_count=None, decay_step_size=0,
                 cycle_momentum=True, cycle_min_mom=0.85, cycle_max_mom=0.99,
                 decay_mom_rate=0.0, last_batch_iteration=-1):
        super().__init__()
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = (cycle_second_step_size
                            if cycle_second_step_size is not None
                            else cycle_first_step_size)
        self.decay_step_size = decay_step_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate
        self.last_batch_iteration = last_batch_iteration

    @property
    def total_size(self):
        return self.first_size + self.second_size

    def get_lr_at(self, step):
        if step < self.total_size:
            if step < self.first_size:
                x = step / self.first_size
            else:
                x = 1.0 - (step - self.first_size) / self.second_size
            return self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * x
        # decay phase
        decay_steps = step - self.total_size
        if self.decay_step_size > 0:
            decay_steps //= self.decay_step_size
        return self.cycle_min_lr / (1.0 + decay_steps * self.decay_lr_rate)

    def get_mom_at(self, step):
        if not self.cycle_momentum:
            return self.cycle_max_mom
        if step < self.total_size:
            if step < self.first_size:
                x = step / self.first_size
            else:
                x = 1.0 - (step - self.first_size) / self.second_size
            return self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * x
        decay_steps = step - self.total_size
        if self.decay_step_size > 0:
            decay_steps //= self.decay_step_size
        return self.cycle_max_mom * (1.0 + decay_steps * self.decay_mom_rate)


SCHEDULES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    WARMUP_COSINE_LR: WarmupCosineLR,
}


def get_lr_scheduler(name, params, optimizer=None):
    if name not in SCHEDULES:
        raise ValueError(
            f"{name} is not a valid LR schedule. Valid: {VALID_LR_SCHEDULES}")
    return SCHEDULES[name](optimizer=optimizer, **params)
