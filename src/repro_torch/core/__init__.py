"""FLoCoRA core: LoRA adapters, the flat-tree wire codec, aggregation.

Public API re-exports.
"""
from repro_torch.core.flocora import FLoCoRAConfig, broadcast, \
    client_uplink, client_wire_bytes, fleet_tcc_bytes, round_wire_bytes, \
    server_downlink, server_round, tcc
from repro_torch.core.aggregation import ErrorFeedbackFedAvg, \
    FedAvgAggregator, ef_encode_packed, ef_fold_dropped, fedavg, \
    fedavg_packed, fedavg_quantized
from repro_torch.core.flat import FlatPackedMessage, fedavg_packed_flat, \
    layout_for, pack_flat
from repro_torch.core.messages import pack_message, unpack_message, \
    packed_wire_bytes, message_wire_bytes, message_rank, message_to_wire, \
    message_from_wire, parse_wire_header
from repro_torch.core.lora import LoRAConfig, conv_lora_init, \
    conv_lora_apply, conv_merge, dense_lora_init, dense_lora_apply, \
    dense_merge, adapter_rank, is_adapter_pair, tree_ranks, tree_max_rank
from repro_torch.core.quant import QuantConfig
from repro_torch.core import messages, aggregation
