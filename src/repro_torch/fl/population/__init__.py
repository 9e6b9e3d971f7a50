"""Cohort paging engine (counterpart of `repro.fl.population`): the
host-backed client-state store, the cohort schedules, and the paged
synchronous and buffered-async engines.

    from repro_torch.fl import PagingConfig, run_federated
    run_federated("ucfl_k2", fed, paging=PagingConfig(cohort=8))
"""
from repro_torch.fl.population.paging import (PagingConfig, run_async_paged,
                                              run_paged, sub_federated)
from repro_torch.fl.population.schedule import (CohortSchedule, FixedCohort,
                                                RandomCohorts,
                                                SequentialSweep)
from repro_torch.fl.population.store import ClientStateStore

__all__ = ["ClientStateStore", "CohortSchedule", "FixedCohort",
           "PagingConfig", "RandomCohorts", "SequentialSweep",
           "run_async_paged", "run_paged", "sub_federated"]
