"""The model executable entry point.

Mirrors ``main()`` (``core/src/main.cpp:14-37``): wire the command line into
the Configurator, collect config files, apply module defaults then
config-driven selections, then configure and run the Model.

Run as: ``python -m nextsimdg_tpu --config-file run/dev1.cfg``
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from ..config import CommandLineParser, Configurator, ConfiguredModule
from ..modules import ModuleRegistry
from ..utils.compile_cache import enable_compile_cache
from ..utils.timer import main_timer
from .model import Model


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    argv = list(sys.argv if argv is None else argv)

    # Pass the command line to the Configurator (so config options can be
    # overridden with --section.key=value), then gather config files.
    Configurator.set_command_line(argv)
    cmd_line = CommandLineParser(argv)
    if cmd_line.help_requested:
        return 0
    Configurator.add_files(cmd_line.get_config_file_names())

    # Import physics/grid packages so their modules register, then select.
    import nextsimdg_tpu.physics  # noqa: F401
    import nextsimdg_tpu.grid  # noqa: F401

    loader = ModuleRegistry.get_loader()
    loader.set_all_defaults()
    ConfiguredModule.parse_configurator()

    model = Model()
    model.configure()
    model.run()
    print(main_timer.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
