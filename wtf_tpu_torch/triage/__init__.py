"""Crash triage.  This slice carries the crash bucket key the fuzz loop's
harvest dedups by (bucket.py, copied from wtf_tpu/triage/bucket.py)."""
