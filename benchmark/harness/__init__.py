"""The benchmark's harness: manifest lookup, traffic, the timed block
loop, trace reduction, the check against the plain reference."""
