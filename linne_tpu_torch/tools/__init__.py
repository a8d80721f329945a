"""Command-line tools that drive the port's entry points over a corpus."""
