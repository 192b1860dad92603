"""Test and chaos harnesses of the port (testing/faultinject.py), its
multi-process worker and its smokes (`python -m
wtf_tpu_torch.testing.<name>`)."""
