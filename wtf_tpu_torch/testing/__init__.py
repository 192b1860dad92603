"""Test and chaos harnesses of the port (testing/faultinject.py)."""
