"""Configuration-system tests.

Ports the reference test cases from ``core/test/Configurator_test.cpp``,
``core/test/CommandLineParser_test.cpp`` and
``core/test/ConfiguredModule_test.cpp`` to this framework's config stack.
"""

import pytest

from nextsimdg_tpu.config import (
    CommandLineParser,
    Configurator,
    Configured,
    ConfiguredModule,
    OptionsDescription,
    try_configure,
)
from nextsimdg_tpu.config.configurator import parse_ini
from nextsimdg_tpu.modules import ModuleError, ModuleRegistry, register_implementation


class Config1:
    """Raw-configurator consumer (Configurator_test.cpp Config1)."""

    def __init__(self):
        self.value = 0

    def configure(self):
        desc = OptionsDescription().add("config.value", int, -1)
        self.value = Configurator.parse(desc)["config.value"]


class Config2(Configured):
    """Staged add_option/retrieve_value consumer (Config2)."""

    def __init__(self):
        self.value = 0
        self.name = ""
        Config2.add_option("config.value", -1)
        Config2.add_option("config.name", "")

    def configure(self):
        self.value = Config2.retrieve_value("config.value")
        self.name = Config2.retrieve_value("config.name")


class Config3(Configured):
    """get_configuration consumer spanning two sections (Config3)."""

    def __init__(self):
        self.value = 0
        self.weight = 0.0

    def configure(self):
        self.value = Configured.get_configuration("config.value", -1)
        self.weight = Configured.get_configuration("data.weight", 1.0)


def test_parse_one_stream_raw_configurator():
    config = Config1()
    assert config.value == 0
    config.configure()
    assert config.value == -1  # default when no sources registered
    Configurator.add_stream("[config]\nvalue = 42\n")
    config.configure()
    assert config.value == 42


def test_parse_one_stream_pointer_function():
    Config2.clear_configuration_map()
    config = Config2()
    Configurator.add_stream("[config]\nvalue = 69105\nname = Zork\n")
    assert try_configure(config)
    assert config.value == 69105
    assert config.name == "Zork"


def test_parse_two_streams_one_class():
    Config2.clear_configuration_map()
    config = Config2()
    Configurator.add_stream("[config]\nvalue = 69105\n")
    Configurator.add_stream("[config]\nname = Zork\n")
    try_configure(config)
    assert config.value == 69105
    assert config.name == "Zork"


def test_parse_streams_two_overlapping_classes():
    Config2.clear_configuration_map()
    config = Config2()
    confih = Config3()
    Configurator.add_stream("[config]\nvalue = 69105\nname = Zork II\n")
    Configurator.add_stream("[data]\nweight = 0.467836\n")
    try_configure(config)
    try_configure(confih)
    assert config.value == 69105
    assert config.name == "Zork II"
    assert confih.value == 69105
    assert confih.weight == 0.467836


def test_first_parsed_wins_command_line_beats_streams():
    Configurator.set_command_line(["prog", "--config.value=7"])
    Configurator.add_stream("[config]\nvalue = 42\n")
    config = Config1()
    config.configure()
    assert config.value == 7


def test_first_parsed_wins_earlier_stream_beats_later():
    Configurator.add_stream("[config]\nvalue = 1\n")
    Configurator.add_stream("[config]\nvalue = 2\n")
    config = Config1()
    config.configure()
    assert config.value == 1


def test_malformed_stream_is_skipped(capsys):
    Configurator.add_stream("this is not INI at all\n")
    Configurator.add_stream("[config]\nvalue = 13\n")
    config = Config1()
    config.configure()
    assert config.value == 13
    assert "error" in capsys.readouterr().err.lower()


def test_unknown_options_are_ignored():
    Configurator.add_stream("[other]\nsomething = 1\n[config]\nvalue = 5\nextra = 9\n")
    config = Config1()
    config.configure()
    assert config.value == 5


def test_parse_ini_sections_comments_and_bare_keys():
    pairs = parse_ini(
        "# comment\n"
        "bare = 1\n"
        "[sec]\n"
        "a = hello world \n"
        "; another comment\n"
        "b = 2 # trailing\n"
    )
    assert pairs == [("bare", "1"), ("sec.a", "hello world"), ("sec.b", "2")]


def test_command_line_parser_single_file():
    parser = CommandLineParser(["nextsim", "--config-file", "a.cfg"])
    assert parser.get_config_file_names() == ["a.cfg"]


def test_command_line_parser_multiple_files_preserve_order():
    parser = CommandLineParser(
        ["nextsim", "--config-files", "z.cfg", "a.cfg", "m.cfg"]
    )
    assert parser.get_config_file_names() == ["z.cfg", "a.cfg", "m.cfg"]


def test_command_line_parser_help(capsys):
    parser = CommandLineParser(["nextsim", "--help"])
    assert parser.help_requested
    assert "config-file" in capsys.readouterr().out


# -- module registry + config-driven selection -------------------------------

class ITest:
    def operation(self):
        raise NotImplementedError


@register_implementation("Nextsim::ITest", "Nextsim::Impl1")
class Impl1(ITest):
    def operation(self):
        return 1


@register_implementation("Nextsim::ITest", "Nextsim::Impl2")
class Impl2(ITest):
    def operation(self):
        return 2


def test_module_default_is_first_registered():
    loader = ModuleRegistry.get_loader()
    loader.set_all_defaults()
    assert loader.get_implementation("Nextsim::ITest").operation() == 1


def test_module_selection_and_fresh_instance():
    loader = ModuleRegistry.get_loader()
    loader.set_implementation("Nextsim::ITest", "Nextsim::Impl2")
    assert loader.get_implementation("Nextsim::ITest").operation() == 2
    a = loader.get_instance("Nextsim::ITest")
    b = loader.get_instance("Nextsim::ITest")
    assert a is not b
    assert a.operation() == 2


def test_module_static_instance_is_cached():
    loader = ModuleRegistry.get_loader()
    loader.set_default("Nextsim::ITest")
    assert loader.get_implementation("Nextsim::ITest") is loader.get_implementation(
        "Nextsim::ITest"
    )


def test_unknown_implementation_raises():
    loader = ModuleRegistry.get_loader()
    with pytest.raises(ModuleError):
        loader.set_implementation("Nextsim::ITest", "Nextsim::NoSuchImpl")
    with pytest.raises(ModuleError):
        loader.set_implementation("Nextsim::NoSuchInterface", "Nextsim::Impl1")


def test_configured_module_selects_from_config():
    loader = ModuleRegistry.get_loader()
    loader.set_all_defaults()
    Configurator.add_stream("[Modules]\nNextsim::ITest = Nextsim::Impl2\n")
    ConfiguredModule.parse_configurator()
    assert loader.get_implementation("Nextsim::ITest").operation() == 2


def test_configured_module_unknown_impl_raises():
    loader = ModuleRegistry.get_loader()
    loader.set_all_defaults()
    Configurator.add_stream("[Modules]\nNextsim::ITest = Nextsim::Punk\n")
    with pytest.raises(ModuleError):
        ConfiguredModule.parse_configurator()
