"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
every width and count small, the mix's engine, optimizer and law kept."""

import dataclasses

from perfbench import spec

SIZES = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=128,
             num_local_experts=4, vocab_size=256)


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.find_cell(name)
    return dataclasses.replace(
        cell, config=dict(cell.config, **SIZES),
        traffic=dict(cell.traffic, batch=4, seq=32, pool_batches=2))
