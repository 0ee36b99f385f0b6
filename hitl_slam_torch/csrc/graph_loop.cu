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

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// Add the kernel node set_condition(handle, flag) to `graph` after `dep`
// (none when null).
cudaError_t add_test(cudaGraph_t graph, cudaGraphNode_t dep,
                     cudaGraphConditionalHandle handle, const bool* flag,
                     cudaGraphNode_t* node) {
  cudaKernelNodeParams kp = {};
  void* args[] = {&handle, &flag};
  kp.func = reinterpret_cast<void*>(set_condition);
  kp.gridDim = dim3(1, 1, 1);
  kp.blockDim = dim3(1, 1, 1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep ? &dep : nullptr,
                                dep ? 1 : 0, &kp);
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
// *handle is its conditional handle, made on `graph`.
extern "C" int hitl_loop_add_while(void* graph, void** tail, const void* flag,
                                   void** body,
                                   unsigned long long* handle) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t first;
  err = add_test(g, static_cast<cudaGraphNode_t>(*tail), h,
                 static_cast<const bool*>(flag), &first);
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
// the test of `flag` into `handle` before the next trip.
extern "C" int hitl_loop_close_body(void* body, void* tail,
                                    unsigned long long handle,
                                    const void* flag) {
  cudaGraphNode_t next;
  return static_cast<int>(add_test(static_cast<cudaGraph_t>(body),
                                   static_cast<cudaGraphNode_t>(tail),
                                   handle, static_cast<const bool*>(flag),
                                   &next));
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
