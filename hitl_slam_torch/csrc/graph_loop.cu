// Device loops in CUDA graphs: the graph that utils/device_loop.py builds
// around straight-line pieces captured by PyTorch.
//
// A LoopGraph is a chain of nodes. Straight-line work enters it as a child
// graph node (a copy of a graph PyTorch captured); a loop as a one-thread
// kernel node that copies a device bool into a conditional handle (the test
// before the first trip), then a conditional node of type WHILE. The WHILE
// node's body graph is a chain of its own: the trip's pieces as child graph
// nodes, any loop inside the trip as the same pair of nodes (its handle
// made on the body graph that holds it), and last the same one-thread
// kernel (the test before the next trip). The WHILE node runs its body
// while the handle holds a nonzero value, so a replay decides every trip on
// the device and reads nothing back, as the reference's lax.while_loop
// does. Returns are CUDA error codes.
//
// The stage clock. Each graph may carry a buffer of int64 words (layout
// below, mirrored in utils/device_loop.py) that one-thread kernels the
// graph runs anyway stamp with %globaltimer: the loop tests, the kernel
// wrappers' launch counters (hitl_clock_mark), and two nodes of the top
// graph, `begin` first and `end` last. A mark adds the nanoseconds since
// the last mark to the edge (last mark, this mark), counts the mark and
// logs it; `begin` opens a slot of the replay ring and `end` closes it.
// Nothing is read back during a replay.

#include <cuda_runtime.h>

namespace {

// the clock's layout in int64 words: marks a graph may name (ids 0 and 1
// are begin and end), replays the ring holds, marks the log holds
constexpr int kMarks = 32;
constexpr int kRing = 4096;
constexpr int kLog = 65536;
constexpr int kBegin = 0;
constexpr int kEnd = 1;
constexpr int kLastNs = 0;
constexpr int kLastId = 1;
constexpr int kReplays = 2;
constexpr int kLogged = 3;
constexpr int kEdgeNs = 4;                          // [kMarks, kMarks]
constexpr int kEdgeHits = kEdgeNs + kMarks * kMarks;  // [kMarks, kMarks]
constexpr int kHits = kEdgeHits + kMarks * kMarks;    // [kMarks]
constexpr int kRingAt = kHits + kMarks;             // [kRing, 2]: begin, end
constexpr int kLogAt = kRingAt + 2 * kRing;         // [kLog, 2]: ns, id

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// A mark's words are loaded before any is stored, so that a mark waits on
// two round trips to memory (the edge's address depends on the last mark)
// rather than one a word: a mark runs in a one-thread kernel on the path.
__device__ void clock_mark(long long* c, int id, long long t) {
  const long long prev = c[kLastId];
  const long long last = c[kLastNs];
  const long long logged = c[kLogged];
  const long long hits = c[kHits + id];
  const long long edge = prev * kMarks + id;
  const long long ns = c[kEdgeNs + edge];
  const long long n = c[kEdgeHits + edge];
  c[kEdgeNs + edge] = ns + (t - last);
  c[kEdgeHits + edge] = n + 1;
  c[kHits + id] = hits + 1;
  c[kLastNs] = t;
  c[kLastId] = id;
  c[kLogged] = logged + 1;
  c[kLogAt + 2 * (logged % kLog)] = t;
  c[kLogAt + 2 * (logged % kLog) + 1] = id;
}

__global__ void clock_begin(long long* c) {
  const long long t = global_ns();
  const long long replays = c[kReplays];
  const long long hits = c[kHits + kBegin];
  const long long logged = c[kLogged];
  c[kRingAt + 2 * (replays % kRing)] = t;
  c[kRingAt + 2 * (replays % kRing) + 1] = 0;
  c[kHits + kBegin] = hits + 1;
  c[kLastNs] = t;
  c[kLastId] = kBegin;
  c[kLogged] = logged + 1;
  c[kLogAt + 2 * (logged % kLog)] = t;
  c[kLogAt + 2 * (logged % kLog) + 1] = kBegin;
}

__global__ void clock_end(long long* c) {
  const long long t = global_ns();
  const long long replays = c[kReplays];
  clock_mark(c, kEnd, t);
  c[kRingAt + 2 * (replays % kRing) + 1] = t;
  c[kReplays] = replays + 1;
}

// A launch counter's bump, and a mark when the graph has a clock.
__global__ void count_and_mark(long long* counter, long long* clock,
                               int id) {
  if (counter) *counter += 1;
  if (clock) clock_mark(clock, id, global_ns());
}

__global__ void stamp(long long* out) { *out = global_ns(); }

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* flag, long long* clock, int id) {
  if (clock) clock_mark(clock, id, global_ns());
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// Add the one-thread kernel node func(args) to `graph` after `dep` (none
// when null).
cudaError_t add_kernel(cudaGraph_t graph, cudaGraphNode_t dep, void* func,
                       void** args, cudaGraphNode_t* node) {
  cudaKernelNodeParams kp = {};
  kp.func = func;
  kp.gridDim = dim3(1, 1, 1);
  kp.blockDim = dim3(1, 1, 1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep ? &dep : nullptr,
                                dep ? 1 : 0, &kp);
}

// Add the kernel node set_condition(handle, flag, clock, id) to `graph`
// after `dep`.
cudaError_t add_test(cudaGraph_t graph, cudaGraphNode_t dep,
                     cudaGraphConditionalHandle handle, const bool* flag,
                     long long* clock, int id, cudaGraphNode_t* node) {
  void* args[] = {&handle, &flag, &clock, &id};
  return add_kernel(graph, dep, reinterpret_cast<void*>(set_condition), args,
                    node);
}

}  // namespace

extern "C" int hitl_loop_graph_new(void** graph) {
  cudaGraph_t g = nullptr;
  cudaError_t err = cudaGraphCreate(&g, 0);
  *graph = g;
  return static_cast<int>(err);
}

// Append a copy of the captured graph `piece` after *tail; *tail becomes
// the new node.
extern "C" int hitl_loop_append(void* graph, void** tail, void* piece) {
  cudaGraphNode_t dep = static_cast<cudaGraphNode_t>(*tail);
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddChildGraphNode(
      &node, static_cast<cudaGraph_t>(graph), dep ? &dep : nullptr,
      dep ? 1 : 0, static_cast<cudaGraph_t>(piece));
  if (err == cudaSuccess) *tail = node;
  return static_cast<int>(err);
}

// Append a loop after *tail in `graph` (the top graph or a loop's body):
// while the device bool at `flag` holds, run the body graph returned in
// *body, which the caller fills (hitl_loop_append, hitl_loop_add_while)
// and then closes with hitl_loop_close_body. *tail becomes the WHILE node;
// *handle is its conditional handle, made on `graph`. The test marks
// `clock` (none when null) with mark `id`.
extern "C" int hitl_loop_add_while(void* graph, void** tail, const void* flag,
                                   void** body, unsigned long long* handle,
                                   void* clock, int id) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t first;
  err = add_test(g, static_cast<cudaGraphNode_t>(*tail), h,
                 static_cast<const bool*>(flag),
                 static_cast<long long*>(clock), id, &first);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t loop;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&loop, g, &first, nullptr, 1, &p);
#else
  err = cudaGraphAddNode(&loop, g, &first, 1, &p);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  *body = p.conditional.phGraph_out[0];
  *handle = h;
  *tail = loop;
  return 0;
}

// End a loop's body graph (its last node `tail`, null when it has none):
// the test of `flag` into `handle` before the next trip, marking `clock`
// with `id` as the loop's first test does.
extern "C" int hitl_loop_close_body(void* body, void* tail,
                                    unsigned long long handle,
                                    const void* flag, void* clock, int id) {
  cudaGraphNode_t next;
  return static_cast<int>(add_test(static_cast<cudaGraph_t>(body),
                                   static_cast<cudaGraphNode_t>(tail),
                                   handle, static_cast<const bool*>(flag),
                                   static_cast<long long*>(clock), id,
                                   &next));
}

// Append the clock's `begin` node (end = 0) or `end` node (end = 1) after
// *tail in the top graph; *tail becomes the new node.
extern "C" int hitl_loop_add_clock(void* graph, void** tail, void* clock,
                                   int end) {
  long long* c = static_cast<long long*>(clock);
  void* args[] = {&c};
  void* func = end ? reinterpret_cast<void*>(clock_end)
                   : reinterpret_cast<void*>(clock_begin);
  cudaGraphNode_t node;
  cudaError_t err = add_kernel(static_cast<cudaGraph_t>(graph),
                               static_cast<cudaGraphNode_t>(*tail), func,
                               args, &node);
  if (err == cudaSuccess) *tail = node;
  return static_cast<int>(err);
}

// On `stream`: one to the int64 `counter` (none when null) and the mark
// `id` on `clock` (none when null). Captured, it is one kernel node.
extern "C" int hitl_clock_mark(void* counter, void* clock, int id,
                               void* stream) {
  count_and_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(counter), static_cast<long long*>(clock), id);
  return static_cast<int>(cudaGetLastError());
}

// On `stream`: %globaltimer into the int64 at `out`.
extern "C" int hitl_clock_stamp(void* out, void* stream) {
  stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Nodes of a graph, not counting inside child graphs.
extern "C" int hitl_loop_graph_nodes(void* graph, unsigned long long* count) {
  size_t n = 0;
  cudaError_t err =
      cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *count = n;
  return static_cast<int>(err);
}

// Nodes of a graph by type (not counting inside child graphs): counts[t]
// for cudaGraphNodeType t < n.
extern "C" int hitl_loop_node_types(void* graph, unsigned long long* counts,
                                    int n) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &count);
  if (err != cudaSuccess || count == 0) return static_cast<int>(err);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[count];
  err = cudaGraphGetNodes(g, nodes, &count);
  for (size_t i = 0; err == cudaSuccess && i < count; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err == cudaSuccess && static_cast<int>(type) < n) ++counts[type];
  }
  delete[] nodes;
  return static_cast<int>(err);
}

extern "C" int hitl_loop_instantiate(void* graph, void** exec) {
  cudaGraphExec_t e = nullptr;
  cudaError_t err = cudaGraphInstantiate(&e, static_cast<cudaGraph_t>(graph),
                                         0ULL);
  *exec = e;
  return static_cast<int>(err);
}

extern "C" int hitl_loop_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int hitl_loop_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return static_cast<int>(err);
}
