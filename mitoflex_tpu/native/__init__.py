"""Native host runtime (C++).

Compiled on first use from the tracked sources (native/fastq_native.py
builds and caches the library per source contents and host); every
consumer has a pure-Python fallback, so a missing toolchain degrades
performance, not functionality."""
