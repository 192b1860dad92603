from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder
from wtf_tpu_torch.snapshot.loader import Snapshot, load_snapshot
