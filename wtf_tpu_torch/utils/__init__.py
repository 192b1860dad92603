from wtf_tpu_torch.utils.human import bytes_to_human, number_to_human, seconds_to_human
from wtf_tpu_torch.utils.hashing import hex_digest, splitmix64
from wtf_tpu_torch.utils.covfiles import parse_cov_files
