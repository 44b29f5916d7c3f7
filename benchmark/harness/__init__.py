"""The benchmark's harness: manifest lookup, the program's command line,
traffic, the timed block loop, trace reduction, the check against the
plain reference."""
