"""The top-level model object.

Mirrors ``Model`` (``core/src/Model.cpp:22-88``): ``configure()`` reads
``model.{init_file,start,stop,run_length,time_step}``, builds the structure
from the restart file, seeds dummy forcing and wires the ModelStep into the
Iterator; ``run()`` drives the time loop and — like the reference destructor —
always best-effort-writes the final restart file (default ``restart.nc``)
even when the run fails (``Model.cpp:40-53``).
"""

from __future__ import annotations

from ..config import Configured
from ..grid.factory import StructureFactory
from ..state import dummy_forcing
from ..utils.logged import Logged
from ..utils.timer import main_timer
from .iterator import Iterator
from .model_step import ModelStep


class Model(Configured):
    DEFAULT_FINAL_FILENAME = "restart.nc"

    # Config keys (Model.cpp:22-29) + checkpoint cadence (an extension).
    KEYS = {
        "init_file": "model.init_file",
        "start": "model.start",
        "stop": "model.stop",
        "run_length": "model.run_length",
        "time_step": "model.time_step",
        "checkpoint_period": "model.checkpoint_period",
        "checkpoint_pattern": "model.checkpoint_pattern",
    }

    def __init__(self) -> None:
        self.iterator = Iterator()
        self.model_step = ModelStep()
        self.iterator.set_iterant(self.model_step)
        self.structure = None
        self.final_filename = self.DEFAULT_FINAL_FILENAME
        self.initial_filename = ""

    def configure(self) -> None:
        with main_timer.scope("configure"):
            start = Configured.get_configuration(self.KEYS["start"], "0")
            stop = Configured.get_configuration(self.KEYS["stop"], "0")
            duration = Configured.get_configuration(self.KEYS["run_length"], "")
            step = Configured.get_configuration(self.KEYS["time_step"], "1")
            self.iterator.parse_and_set(start, stop, duration, step)

            self.model_step.checkpoint_period = int(
                Configured.get_configuration(self.KEYS["checkpoint_period"], 0)
            )
            self.model_step.checkpoint_pattern = Configured.get_configuration(
                self.KEYS["checkpoint_pattern"], "checkpoint.{step}.nc"
            )

            self.initial_filename = Configured.get_configuration(
                self.KEYS["init_file"], ""
            )
            self.structure = StructureFactory.generate_from_file(self.initial_filename)
            self.model_step.init()
            self.model_step.set_initial_data(self.structure)
            # Real external data handling (the reference's Model.cpp:75-76
            # TODO): a time-interpolating forcing archive when configured,
            # otherwise the reference's constant dummy forcing.
            forcing_file = Configured.get_configuration("model.forcing_file", "")
            if forcing_file:
                from ..io.forcing_file import ForcingProvider

                self.model_step.forcing_provider = ForcingProvider(
                    forcing_file, dtype=self.structure.dtype
                )
                self.model_step.start_time = float(self.iterator.start_time)
            self.structure.forcing = dummy_forcing(
                self.structure.nx, self.structure.ny, dtype=self.structure.dtype
            )

    def set_final_filename(self, filename: str) -> None:
        self.final_filename = filename

    def run(self) -> None:
        """Run the time loop; always attempt the final restart write."""
        try:
            with main_timer.scope("run"):
                self.iterator.run()
        finally:
            try:
                self.write_restart_file()
            except Exception as err:  # Model.cpp:44-52: swallow, report.
                Logged.error(f"Failed writing restart file {self.final_filename}: {err}")

    def write_restart_file(self) -> None:
        with main_timer.scope("restart-write"):
            Logged.info(f"  Writing state-based restart file: {self.final_filename}")
            self.structure.dump(self.final_filename)
