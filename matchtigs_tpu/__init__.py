"""matchtigs_tpu: accelerator tig-compaction engine (JAX/XLA, run on NVIDIA GPUs).

A from-scratch JAX/XLA framework with the capabilities of
algbio/matchtigs (reference at /root/reference): computes pathtigs,
Eulertigs, greedy matchtigs and optimal matchtigs — small/minimum
plain-text representations of k-mer sets — from fasta/GFA/BCALM2 unitigs.
"""

from .graph.bigraph import Bigraph
from .graph.build import (
    build_bigraph_from_links,
    build_bigraph_from_unitigs,
    compute_edge_weights,
)
from .io.sequence_store import SequenceStore
from .io.readers import load_unitigs, read_fasta, read_gfa
from .io.writers import (
    spell_walk,
    spelled_length,
    write_duplication_bitvector,
    write_walks_fasta,
    write_walks_gfa,
)
from .algos.pathtigs import compute_pathtigs
from .algos.eulertigs import EulertigConfig, compute_eulertigs
from .algos.greedytigs import GreedytigConfig, compute_greedytigs
from .algos.matchtigs import MatchtigConfig, compute_matchtigs
from .capi import TigGraphBuilder

__version__ = "0.1.0"
