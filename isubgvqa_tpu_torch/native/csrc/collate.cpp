// Native dense-batch collate fill of the PyTorch port: the per-graph
// loop of isubgvqa_tpu_torch/data/batching.py:Collator, in C++.
//
// The card runs the eval forward at ~100k questions/s at batch 2048,
// while the Python fill loop under the interpreter lock keeps the end-
// to-end pipeline at a fraction of that.  This fill is plain memcpy-
// bound C++ driven through ctypes: the call releases the GIL, so the
// prefetch thread's collation overlaps the Python work of the main
// thread.  It reads graphs from the columnar PackedGraphStore
// (contiguous node / edge arrays + offsets, native/collate.py) and
// writes every element of its outputs, which may live in pinned host
// memory handed out by PyTorch.
//
// Semantics are exactly the Python fill's (tests/test_torch_port_
// native.py holds them bit-exact): nodes beyond the cap are truncated
// and counted; edges touching truncated nodes are dropped; kept edges
// beyond the edge cap are truncated and counted; pad values are
// <pad>=1 for node and edge tokens, 1.0 for edge_sign, 0 elsewhere.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

void isubgvqa_collate_fill(
    // packed store (columnar, C-contiguous)
    const int32_t* nt,    // [total_nodes, 4] node tokens
    const float* nb,      // [total_nodes, 4] node bbox
    const int32_t* es,    // [total_edges] edge src (within-graph)
    const int32_t* ed,    // [total_edges] edge dst
    const int32_t* et,    // [total_edges] edge token
    const float* esg,     // [total_edges] edge sign
    const int64_t* noff,  // [n_graphs + 1] node offsets
    const int64_t* eoff,  // [n_graphs + 1] edge offsets
    // batch request
    const int64_t* rows,       // [num_real] store row per sample
    const int32_t* labels_in,  // [num_real]
    int64_t num_real, int64_t B, int64_t N, int64_t E,
    // outputs (uninitialized; this kernel writes every element)
    int32_t* out_nt,    // [B, N, 4]
    float* out_nb,      // [B, N, 4]
    uint8_t* out_nm,    // [B, N] node mask
    int32_t* out_es,    // [B, E]
    int32_t* out_ed,    // [B, E]
    int32_t* out_et,    // [B, E]
    float* out_esg,     // [B, E]
    uint8_t* out_em,    // [B, E] edge mask
    int32_t* out_labels,  // [B]
    float* out_sm,        // [B] sample mask
    int64_t* trunc)       // [2] accumulates: truncated nodes, edges
{
  // pad fills (those of data/batching.py:Collator._collate_python)
  std::fill(out_nt, out_nt + B * N * 4, 1);  // <pad> token id 1
  std::memset(out_nb, 0, sizeof(float) * B * N * 4);
  std::memset(out_nm, 0, B * N);
  std::memset(out_es, 0, sizeof(int32_t) * B * E);
  std::memset(out_ed, 0, sizeof(int32_t) * B * E);
  std::fill(out_et, out_et + B * E, 1);
  std::fill(out_esg, out_esg + B * E, 1.0f);
  std::memset(out_em, 0, B * E);
  std::memset(out_labels, 0, sizeof(int32_t) * B);
  std::memset(out_sm, 0, sizeof(float) * B);

  int64_t trunc_nodes = 0, trunc_edges = 0;
  for (int64_t gi = 0; gi < num_real; ++gi) {
    const int64_t r = rows[gi];
    const int64_t n0 = noff[r];
    int64_t gn = noff[r + 1] - n0;
    if (gn > N) {
      trunc_nodes += gn - N;
      gn = N;
    }
    std::memcpy(out_nt + gi * N * 4, nt + n0 * 4, sizeof(int32_t) * gn * 4);
    std::memcpy(out_nb + gi * N * 4, nb + n0 * 4, sizeof(float) * gn * 4);
    std::memset(out_nm + gi * N, 1, gn);

    const int64_t e0 = eoff[r], e1 = eoff[r + 1];
    int64_t w = 0;
    for (int64_t k = e0; k < e1; ++k) {
      const int32_t s = es[k], d = ed[k];
      if (s < gn && d < gn) {       // drop edges touching cut nodes
        if (w < E) {
          out_es[gi * E + w] = s;
          out_ed[gi * E + w] = d;
          out_et[gi * E + w] = et[k];
          out_esg[gi * E + w] = esg[k];
          out_em[gi * E + w] = 1;
          ++w;
        } else {
          ++trunc_edges;            // kept but beyond the edge cap
        }
      }
    }
    out_labels[gi] = labels_in[gi];
    out_sm[gi] = 1.0f;
  }
  trunc[0] += trunc_nodes;
  trunc[1] += trunc_edges;
}

}  // extern "C"
