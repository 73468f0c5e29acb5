"""Generic time-dependent tensor-network job.

MPS-agnostic evolution loop (reference ``renormalizer/utils/tdmps.py:19-223``):
``init_mps`` -> loop(``evolve_single_step`` -> ``process_mps`` -> atomic npz
dump with ``.bak`` swap) with flexible (dt, nsteps, total-time) argument
logic and optional MPS snapshot dumping.

Numpy copy of ``renormalizer_tpu/utils/tdmps.py``: thin host-side
orchestration; all device work happens in the engine layers (mps/, ops/,
lib/).
"""

import logging
import os
from datetime import datetime

import numpy as np

from renormalizer_tpu_torch.utils.configs import EvolveConfig

logger = logging.getLogger(__name__)


class TdMpsJob:
    def __init__(
        self,
        evolve_config: EvolveConfig = None,
        dump_mps: str = None,
        dump_dir: str = None,
        job_name: str = None,
    ):
        logger.info(f"Creating TDMPS job. dump_dir: {dump_dir}. job_name: {job_name}")
        self.evolve_config = evolve_config if evolve_config is not None else EvolveConfig()
        self.evolve_times = [0]
        # output an abstract of the current state every `info_interval` steps
        self.info_interval = 1
        if dump_mps not in (None, "all", "one"):
            raise ValueError(f"dump_mps should be None, 'all', 'one'. Got {dump_mps}")
        self.dump_mps = dump_mps
        self._dump_mps_this_step = None
        self.dump_dir = dump_dir
        self.job_name = job_name
        logger.info("Step 0/?. Preparing the initial state.")
        mps = self.init_mps()
        if mps is None:
            raise ValueError("init_mps should return an mps. Got None")
        self.latest_mps = mps
        self.process_mps(mps)
        logger.info("TDMPS job created.")

    # --- subclass hooks -------------------------------------------------
    def init_mps(self):
        raise NotImplementedError

    def process_mps(self, mps):
        """Measure properties on the newly evolved state.
        ``self.latest_mps`` is not yet updated when this is called."""
        raise NotImplementedError

    def evolve_single_step(self, evolve_dt):
        raise NotImplementedError

    def get_dump_dict(self) -> dict:
        raise NotImplementedError

    def stop_evolve_criteria(self) -> bool:
        return False

    # --- evolution loop ---------------------------------------------------
    def evolve(self, evolve_dt=None, nsteps=None, evolve_time=None):
        """Run the evolution loop.

        ``evolve_dt * nsteps = evolve_time``; any two determine the third.
        With only ``evolve_dt`` given, evolution runs until
        ``stop_evolve_criteria`` fires.
        """
        if evolve_dt is None and nsteps is not None and evolve_time is not None:
            evolve_dt = evolve_time / float(nsteps)
        elif evolve_dt is not None and nsteps is None and evolve_time is not None:
            nsteps = int(abs(evolve_time) // abs(evolve_dt)) + 1
        elif evolve_dt is not None and nsteps is None and evolve_time is None:
            logger.info("evolution will stop by `stop_evolve_criteria`")
            nsteps = int(1e10)
        elif evolve_dt is None or nsteps is None:
            raise ValueError(
                f"invalid combination evolve_dt:{evolve_dt}, "
                f"nsteps:{nsteps}, evolve_time:{evolve_time}"
            )

        target_steps = len(self.evolve_times) + nsteps - 1
        target_time = self.evolve_times[-1] + nsteps * evolve_dt

        wall_start = wall_prev = datetime.now()
        completed = 0
        for i in range(nsteps):
            if self.stop_evolve_criteria():
                logger.info("Criteria to stop the evolution has met. Stop.")
                break
            logger.info(
                f"step {len(self.evolve_times)}/{target_steps}, "
                f"at time {self.latest_evolve_time}/{target_time} begin."
            )
            try:
                new_mps = self.evolve_single_step(evolve_dt)
            except Exception:
                # failure detection: salvage the last good state before
                # propagating the error (reference dumps on OOM,
                # ``utils/tdmps.py:150-170``)
                logger.exception(
                    f"evolution step {len(self.evolve_times)} failed; "
                    "dumping the last good state"
                )
                if self.dump_dir is not None and self.job_name is not None:
                    try:
                        self.latest_mps.dump(
                            os.path.join(self.dump_dir, self.job_name + "_crash.npz")
                        )
                        self.dump_dict()
                    except Exception:
                        logger.exception("crash dump failed")
                raise
            self.evolve_times.append(self.latest_evolve_time + evolve_dt)
            self.process_mps(new_mps)
            self.latest_mps = new_mps
            completed += 1

            now = datetime.now()
            if self.info_interval is not None and i % self.info_interval == 0:
                abstract = str(new_mps)
                self._dump_mps_this_step = self.dump_mps
            else:
                abstract = ""
                self._dump_mps_this_step = None
            logger.info(
                f"step {len(self.evolve_times) - 1} complete, "
                f"time cost {now - wall_prev}. {abstract}"
            )
            wall_prev = now

            if self._defined_output_path:
                try:
                    self.dump_dict()
                except IOError:
                    # never kill a long calculation because of disk trouble
                    logger.exception("dumping dict failed with IOError")

        logger.info(f"{completed} steps of evolution complete!")
        logger.info(f"Normal termination. Time cost: {datetime.now() - wall_start}")
        return self

    def dump_dict(self):
        if not self._defined_output_path:
            raise ValueError("Dump dir or job name not set")
        d = self.get_dump_dict()
        os.makedirs(self.dump_dir, exist_ok=True)
        file_path = os.path.join(self.dump_dir, self.job_name + ".npz")
        bak_path = file_path + ".bak"
        # atomic-ish write: keep a backup in case of kill-during-write
        if os.path.exists(file_path):
            if os.path.exists(bak_path):
                os.remove(bak_path)
            os.rename(file_path, bak_path)
        np.savez(file_path, **d)
        if os.path.exists(bak_path):
            os.remove(bak_path)

        if self._dump_mps_this_step is not None:
            if self._dump_mps_this_step == "all":
                suffix = f"_mps_{len(self.evolve_times) - 1}.npz"
            else:
                suffix = "_mps.npz"
            self.latest_mps.dump(os.path.join(self.dump_dir, self.job_name + suffix))

    @property
    def latest_evolve_time(self):
        return self.evolve_times[-1]

    @property
    def evolve_times_array(self):
        return np.array(self.evolve_times)

    @property
    def _defined_output_path(self):
        return self.dump_dir is not None and self.job_name is not None
