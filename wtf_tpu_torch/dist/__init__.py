"""Distribution plane: master/node fuzzing over TCP or Unix sockets.

Reference layer L5 (SURVEY.md §2.3): `Server_t` master + `Client_t` nodes
speaking u32-length-prefixed messages.  The master is completely backend-
agnostic — a GPU batch node (client.BatchClient) looks like n_lanes
ordinary single-testcase nodes, preserving the reference's master
unmodified (the BASELINE.json north-star property).

  wire    - address scheme, framing, result serialization
  server  - master reactor: corpus replay -> mutation, coverage set-union,
            crash saving, runs budget / minset mode
  client  - node loop: run_testcase_and_restore over any Backend
"""

from wtf_tpu_torch.dist.client import (
    BatchClient, Client, MasterLink, run_testcase_and_restore,
)
from wtf_tpu_torch.dist.server import Server, ServerStats

__all__ = [
    "BatchClient", "Client", "MasterLink", "Server", "ServerStats",
    "run_testcase_and_restore",
]
