"""One reader a metric family: ``bench/metrics/<family>.py`` holds
``read(run)``, which returns the metric's value for a finished run
(``bench.harness.Run``), or None where the run has nothing to read.
A metric ``<family>.<split>`` is read by its family's reader."""
