"""mapAD's `map` settings beyond the production family, as command lines.

The production family (`BASE_FLAGS`: a single-stranded library, the
Discrete bound `-p`, base qualities on, gaps at least 5 bp from a read's
ends, at most two open) is what every other path maps with.  `SETTINGS`
names the other settings of mapAD's `map` options, each as the flags it
replaces or adds (None: the flag is dropped):

  ds         a double-stranded library (G->A at the 3' end);
  cutoff     the Continuous bound `-c 0.15 -e 1.0` in place of `-p`: every
             read's threshold is scaled by len^e;
  ibq        `--ignore_base_quality`;
  gaps_0_1   gaps allowed at the read's first and last base, one open;
  gaps_10_3  gaps at least 10 bp from the ends, three open;
  no_gaps    `--max_num_gaps_open 0`: no gap candidate at all;
  abort      `--no_search_limit_recovery` (the host searcher's limit);
  rg         `-R` with an @RG header line.

`flags(name)` gives a setting's whole flag list, `parameters(cli, name)`
the AlignmentParameters that `cli` (a module with mapAD's parser and
`build_alignment_parameters`) builds from it.
"""

from __future__ import annotations

BASE_FLAGS = ["-p", "0.03", "-l", "single_stranded", "-f", "0.6", "-t",
              "0.55", "-d", "0.01", "-s", "1.0", "-i", "0.001"]

# flags that take no value
SWITCHES = ("--ignore_base_quality", "--no_search_limit_recovery")

SETTINGS = {
    "ds": {"-l": "double_stranded", "-f": "0.475", "-d": "0.01",
           "-s": "0.9", "-p": "0.04", "-i": "0.00001"},
    "cutoff": {"-p": None, "-c": "0.15", "-e": "1.0", "-f": "0.475",
               "-t": "0.475", "-d": "0.001", "-s": "0.9", "-i": "0.0001"},
    "ibq": {"--ignore_base_quality": True},
    "gaps_0_1": {"--gap_dist_ends": "0", "--max_num_gaps_open": "1"},
    "gaps_10_3": {"--gap_dist_ends": "10", "--max_num_gaps_open": "3"},
    "no_gaps": {"--max_num_gaps_open": "0"},
    "abort": {"--no_search_limit_recovery": True},
    "rg": {"-R": "@RG\\tID:configs\\tSM:sample14"},
}

# the library each setting's reads are drawn from (tools/assembly.py
# make_reads)
LIBRARY = {name: "double_stranded" if name == "ds" else "single_stranded"
           for name in SETTINGS}


def _pairs(argv):
    out, i = {}, 0
    while i < len(argv):
        if argv[i] in SWITCHES:
            out[argv[i]] = True
            i += 1
        else:
            out[argv[i]] = argv[i + 1]
            i += 2
    return out


def flags(name: str, base=None, changes=None) -> list:
    """The flags of setting `name` ("base": `base` itself): `base`
    (BASE_FLAGS by default) with the setting's flags replacing or joining
    its own.  `changes` overrides SETTINGS[name]."""
    pairs = _pairs(BASE_FLAGS if base is None else base)
    pairs.update(SETTINGS.get(name, {}) if changes is None else changes)
    out = []
    for flag, value in pairs.items():
        if value is True:
            out.append(flag)
        elif value is not None:
            out += [flag, value]
    return out


def parameters(cli, name: str, changes=None, base=None):
    """The AlignmentParameters of setting `name` (on `base`) as `cli`
    builds them from the command line."""
    args = cli.build_parser().parse_args(
        ["map", "-r", "x", "-g", "x", "-o", "x",
         *flags(name, base, changes)])
    return cli.build_alignment_parameters(args)

