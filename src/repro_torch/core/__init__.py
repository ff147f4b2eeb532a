"""FLoCoRA core: LoRA adapters, the flat-tree wire codec, aggregation.

Public API re-exports.
"""
from repro_torch.core.flocora import FLoCoRAConfig, RankSchedule, \
    broadcast, client_uplink, client_wire_bytes, fleet_tcc_bytes, \
    round_wire_bytes, server_downlink, server_round, tcc
from repro_torch.core.aggregation import Aggregator, ErrorFeedbackFedAvg, \
    FedAvgAggregator, FedBuffAggregator, StreamingFlatAccumulator, \
    SVDRecombinationAggregator, bucket_by_rank, ef_encode_packed, \
    ef_fold_dropped, fedavg, fedavg_hetero, fedavg_packed, fedavg_quantized
from repro_torch.core.flat import FlatPackedMessage, fedavg_packed_flat, \
    layout_for, pack_flat
from repro_torch.core.messages import pack_message, unpack_message, \
    packed_wire_bytes, message_wire_bytes, message_rank, message_to_wire, \
    message_from_wire, message_density, parse_wire_header
from repro_torch.core.sparse import SparseLeaf, SparsityConfig, \
    is_sparse_leaf, sparse_leaf_wire_bytes, sparsify_leaf, sparsify_leaves
from repro_torch.core.lora import LoRAConfig, conv_lora_init, \
    conv_lora_apply, conv_merge, dense_lora_init, dense_lora_apply, \
    dense_merge, linear_init, linear_apply, adapter_rank, \
    is_adapter_pair, pad_adapter, \
    slice_adapter, truncate_adapter, resize_adapter, resize_tree_rank, \
    tree_ranks, tree_max_rank, svd_energy_rank
from repro_torch.core.quant import DPConfig, QuantConfig, dp_privatize, \
    gaussian_epsilon
from repro_torch.core import messages, aggregation
