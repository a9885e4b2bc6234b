// Dinic max-flow / min-cut for the rematerialization pass.
//
// Reference parity: thunder/core/rematerialization.py:245 uses igraph's
// C max-flow for the save-vs-recompute cut between forward and backward
// traces; this is the equivalent native component, built in-repo (C++,
// ~150 LoC) instead of an external library dependency.
//
// C ABI:
//   tt_mincut(n, m, edges_u, edges_v, caps, s, t, side_out) -> maxflow
//     n nodes, m directed edges (u->v with capacity caps[i], int64;
//     capacity INT64_MAX/4 treated as infinite). After the run,
//     side_out[i] = 1 if node i is reachable from s in the residual
//     graph (source side of the min cut), else 0.
//
// Build: g++ -O2 -shared -fPIC mincut.cpp -o libttmincut.so (done at first use by
// thunder_tpu_torch/transforms/mincut.py, into thunder_tpu_torch/_build/).

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Edge {
  int to;
  int64_t cap;
  int rev;  // index of reverse edge in graph[to]
};

struct Dinic {
  std::vector<std::vector<Edge>> g;
  std::vector<int> level, iter;

  explicit Dinic(int n) : g(n), level(n), iter(n) {}

  void add_edge(int u, int v, int64_t cap) {
    g[u].push_back({v, cap, static_cast<int>(g[v].size())});
    g[v].push_back({u, 0, static_cast<int>(g[u].size()) - 1});
  }

  bool bfs(int s, int t) {
    std::fill(level.begin(), level.end(), -1);
    std::queue<int> q;
    level[s] = 0;
    q.push(s);
    while (!q.empty()) {
      int u = q.front();
      q.pop();
      for (const Edge& e : g[u]) {
        if (e.cap > 0 && level[e.to] < 0) {
          level[e.to] = level[u] + 1;
          q.push(e.to);
        }
      }
    }
    return level[t] >= 0;
  }

  int64_t dfs(int u, int t, int64_t f) {
    if (u == t) return f;
    for (int& i = iter[u]; i < static_cast<int>(g[u].size()); ++i) {
      Edge& e = g[u][i];
      if (e.cap > 0 && level[u] < level[e.to]) {
        int64_t d = dfs(e.to, t, f < e.cap ? f : e.cap);
        if (d > 0) {
          e.cap -= d;
          g[e.to][e.rev].cap += d;
          return d;
        }
      }
    }
    return 0;
  }

  int64_t max_flow(int s, int t) {
    int64_t flow = 0;
    const int64_t INF = INT64_MAX / 2;
    while (bfs(s, t)) {
      std::fill(iter.begin(), iter.end(), 0);
      int64_t f;
      while ((f = dfs(s, t, INF)) > 0) flow += f;
    }
    return flow;
  }

  void source_side(int s, uint8_t* side) {
    std::queue<int> q;
    q.push(s);
    side[s] = 1;
    while (!q.empty()) {
      int u = q.front();
      q.pop();
      for (const Edge& e : g[u]) {
        if (e.cap > 0 && !side[e.to]) {
          side[e.to] = 1;
          q.push(e.to);
        }
      }
    }
  }
};

}  // namespace

extern "C" int64_t tt_mincut(int32_t n, int32_t m, const int32_t* edges_u,
                             const int32_t* edges_v, const int64_t* caps,
                             int32_t s, int32_t t, uint8_t* side_out) {
  Dinic d(n);
  for (int i = 0; i < m; ++i) d.add_edge(edges_u[i], edges_v[i], caps[i]);
  int64_t flow = d.max_flow(s, t);
  std::memset(side_out, 0, n);
  d.source_side(s, side_out);
  return flow;
}
