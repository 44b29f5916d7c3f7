"""The program's command line for a configuration: the CLI's own parser
(`hacktv_tpu_torch.cli._build_parser`) given the configuration's mode,
sample rate and filter, the device, and the deployment's own switches
(the file's optional `switches`, a list of strings).

A configuration may not give a switch that the harness owns, or one
whose output follows the wall clock:

  mode, rate, filter  the file's own keys (`mode`, `sample_rate`,
                      `vfilter`)
  input, output       the traffic mix makes the source from the seed;
                      the harness's sink writes the samples
  devices             the cell's chips (`--device`, `--devices`,
                      `--hosts`, `--host`)
  length, blocks      the measured window, and the mix's
                      `frames_per_block`
  the run itself      `--profile` traces, `--version` and `--list-modes`
                      replace the encoding
  teletext            its clock is the wall clock
  Eurocrypt           without `--nodate`, from a provider dated
                      "TODAY", or with `--ec-ppv`: its ECMs and EMMs
                      carry today's date

Each is refused with a ValueError that names it.
"""

from __future__ import annotations

from hacktv_tpu_torch import cli

_INPUT = "the input: the traffic mix makes the source from the seed"
_OUTPUT = "the output: the harness's sink writes the samples"
_DEVICES = "the devices: the cell's chips"
_LENGTH = "the run's length: the measured window and the mix's blocks"
_RUN = "the run itself: it would trace or replace the encoding"
# refused switches by the parser's dest, with why
OWNED = {
    "mode": "the configuration's `mode`",
    "samplerate": "the configuration's `sample_rate`",
    "vfilter": "the configuration's `vfilter`",
    **dict.fromkeys(("input", "fit", "min_aspect", "max_aspect",
                     "letterbox", "pillarbox", "repeat", "shuffle", "ffmt",
                     "fopts", "passthru", "raw_bb_file", "raw_bb_blanking",
                     "raw_bb_white"), _INPUT),
    **dict.fromkeys(("output", "type", "frequency", "gain", "amp",
                     "antenna", "fl2k_audio"), _OUTPUT),
    **dict.fromkeys(("device", "devices", "hosts", "host"), _DEVICES),
    **dict.fromkeys(("frames", "seconds", "frames_per_block"), _LENGTH),
    **dict.fromkeys(("profile", "list_modes", "json", "version"), _RUN),
    "teletext": "teletext's clock is the wall clock",
    "ec_ppv": "its EMMs carry today's date (the wall clock)",
}
_UNSET = object()


def _parse(parser, argv: list):
    try:
        return parser.parse_args(argv)
    except SystemExit:
        raise ValueError(f"the switches {argv} do not parse with the "
                         "CLI's parser (its message is above)") from None


def refuse(switches: list) -> None:
    """Raise a ValueError naming the first switch of `switches` that a
    configuration may not give (this module's docstring), however spelt:
    abbreviated, joined to its value, positional."""
    parser = cli._build_parser()
    # each switch as a user types it (a positional by its dest)
    names = {a.dest: "/".join(a.option_strings) or a.dest
             for a in parser._actions if a.dest != "help"}
    # what no switch sets reads as unset, whatever its default
    parser.set_defaults(**dict.fromkeys(names, _UNSET))
    ns = _parse(parser, list(switches))
    bad = [d for d in names if d in OWNED and getattr(ns, d) is not _UNSET]
    if bad:
        raise ValueError(f"switch {names[bad[0]]} ({' '.join(switches)}) "
                         f"is refused: {OWNED[bad[0]]}")
    if ns.eurocrypt is not _UNSET:
        if ns.nodate is _UNSET:
            raise ValueError("switch --eurocrypt without --nodate is "
                             "refused: its ECMs carry today's date")
        from hacktv_tpu_torch.services.eurocrypt import EC_MODES
        mode = EC_MODES.get(ns.eurocrypt)
        if mode is not None and mode.date == "TODAY":
            raise ValueError(f"switch --eurocrypt {ns.eurocrypt} is "
                             "refused: that provider's date is TODAY, "
                             "the wall clock's")


def cli_args(config: dict, device_type: str):
    """The CLI's parsed arguments for configuration `config` on a device
    of type `device_type` ("cuda" or "cpu")."""
    switches = list(config.get("switches", []))
    refuse(switches)
    argv = ["-m", config["mode"], "-s", str(config["sample_rate"])]
    if config["vfilter"]:
        argv.append("--filter")
    argv += ["--device", device_type] + switches
    return _parse(cli._build_parser(), argv)
