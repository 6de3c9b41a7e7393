// Native featurization core: SMILES -> perceived molecule -> packed graph
// arrays.
//
// Fills the role RDKit's C++ plays in the reference (chemprop/rdkit.py +
// featurization.py hot loops run inside RDKit/ATen native code;
// SURVEY.md §2.9): parsing, perception and featurization of standard
// molecules at data-pipeline rates, with a thread pool for batch
// throughput. Semantics mirror polymer_chemprop_tpu_torch/chem/{smiles,mol}.py
// and features/featurization.py exactly; the Python path remains the
// reference implementation.
//
// Exposed as a small C API consumed via ctypes (native_ext.py), which
// compiles this file with g++ into build/ at first use.

#include <algorithm>
#include <array>
#include <atomic>
#include <functional>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <tuple>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

// ------------------------------------------------------------------ tables

constexpr int MAX_ATOMIC_NUM = 100;
constexpr int ATOM_FDIM = 133;
constexpr int BOND_FDIM = 14;

struct ElementInfo {
  const char* symbol;
  double mass;
};

// indexed by atomic number (0 = wildcard)
const std::map<std::string, int> kSymbolToNum = {
    {"H", 1},   {"He", 2},  {"Li", 3},  {"Be", 4},  {"B", 5},   {"C", 6},
    {"N", 7},   {"O", 8},   {"F", 9},   {"Ne", 10}, {"Na", 11}, {"Mg", 12},
    {"Al", 13}, {"Si", 14}, {"P", 15},  {"S", 16},  {"Cl", 17}, {"Ar", 18},
    {"K", 19},  {"Ca", 20}, {"Sc", 21}, {"Ti", 22}, {"V", 23},  {"Cr", 24},
    {"Mn", 25}, {"Fe", 26}, {"Co", 27}, {"Ni", 28}, {"Cu", 29}, {"Zn", 30},
    {"Ga", 31}, {"Ge", 32}, {"As", 33}, {"Se", 34}, {"Br", 35}, {"Kr", 36},
    {"Rb", 37}, {"Sr", 38}, {"Y", 39},  {"Zr", 40}, {"Nb", 41}, {"Mo", 42},
    {"Tc", 43}, {"Ru", 44}, {"Rh", 45}, {"Pd", 46}, {"Ag", 47}, {"Cd", 48},
    {"In", 49}, {"Sn", 50}, {"Sb", 51}, {"Te", 52}, {"I", 53},  {"Xe", 54},
    {"Cs", 55}, {"Ba", 56}, {"La", 57}, {"Pt", 78}, {"Au", 79}, {"Hg", 80},
    {"Tl", 81}, {"Pb", 82}, {"Bi", 83}, {"*", 0},
};

const double kMass[104] = {
    0.0,    1.008,  4.003,  6.941,  9.012,  10.811, 12.011, 14.007, 15.999,
    18.998, 20.180, 22.990, 24.305, 26.982, 28.086, 30.974, 32.067, 35.453,
    39.948, 39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845,
    58.933, 58.693, 63.546, 65.39,  69.723, 72.61,  74.922, 78.96,  79.904,
    83.80,  85.468, 87.62,  88.906, 91.224, 92.906, 95.94,  98.0,   101.07,
    102.906,106.42, 107.868,112.412,114.818,118.711,121.760,127.60, 126.904,
    131.29, 132.905,137.328,138.906,140.116,140.908,144.24, 145.0,  150.36,
    151.964,157.25, 158.925,162.50, 164.930,167.26, 168.934,173.04, 174.967,
    178.49, 180.948,183.84, 186.207,190.23, 192.217,195.078,196.967,200.59,
    204.383,207.2,  208.980,209.0,  210.0,  222.0,  223.0,  226.0,  227.0,
    232.038,231.036,238.029,237.0,  244.0,  243.0,  247.0,  247.0,  251.0,
    252.0,  257.0,  258.0,  259.0,  262.0};

const int kOuter[55] = {2, 1, 2, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4, 5, 6,
                        7, 8, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 4, 5,
                        6, 7, 8, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 4,
                        5, 6, 7, 8};

int outer_electrons(int z) { return (z >= 0 && z < 55) ? kOuter[z] : 2; }

std::vector<int> default_valence(int z, int charge) {
  std::vector<int> base;
  switch (z) {
    case 1: base = {1}; break;
    case 5: base = {3}; break;
    case 6: base = {4}; break;
    case 7: base = {3, 5}; break;
    case 8: base = {2}; break;
    case 9: base = {1}; break;
    case 15: base = {3, 5}; break;
    case 16: base = {2, 4, 6}; break;
    case 17: base = {1}; break;
    case 35: base = {1}; break;
    case 53: base = {1}; break;
    default: return {};
  }
  if (charge == 0) return base;
  int outer = outer_electrons(z);
  std::vector<int> out;
  if (charge > 0) {
    for (int v : base) out.push_back(outer > 4 ? v + charge
                                               : std::max(0, v - charge));
  } else {
    for (int v : base) out.push_back(outer >= 4 ? std::max(0, v + charge)
                                                : std::max(0, v - charge));
  }
  return out;
}

// --------------------------------------------------------------- molecule

constexpr int ORDER_SINGLE = 1;
constexpr int ORDER_DOUBLE = 2;
constexpr int ORDER_TRIPLE = 3;
constexpr int ORDER_AROMATIC = 12;

struct Atom {
  int z = 6;
  int charge = 0;
  bool aromatic = false;
  int chiral = 0;      // 0 none, 1 @@ (CW), 2 @ (CCW)
  int isotope = 0;
  int explicit_h = -1; // -1: implicit model
  int map = -1;        // SMILES atom map [X:n]; -1 = none (polymer R tags)
  int num_h = 0;
  bool in_ring = false;
  int hyb = 3;         // index into [SP, SP2, SP3, SP3D, SP3D2]; -1 unknown
};

struct Bond {
  int a1, a2;
  int order;
  bool aromatic = false;
  int direction = 0;   // '/'=1, '\'=-1 relative a1->a2
  bool in_ring = false;
  bool conjugated = false;
  int stereo = 0;      // RDKit BondStereo ints
  int kekule = ORDER_SINGLE;
};

struct Mol {
  std::vector<Atom> atoms;
  std::vector<Bond> bonds;
  std::vector<std::vector<int>> adj;  // atom -> bond ids

  int add_atom(const Atom& a) {
    atoms.push_back(a);
    adj.emplace_back();
    return (int)atoms.size() - 1;
  }
  int add_bond(int a1, int a2, int order, bool arom, int dir) {
    Bond b;
    b.a1 = a1; b.a2 = a2; b.order = order; b.aromatic = arom;
    b.direction = dir;
    bonds.push_back(b);
    int id = (int)bonds.size() - 1;
    adj[a1].push_back(id);
    adj[a2].push_back(id);
    return id;
  }
  int other(int bond, int atom) const {
    return bonds[bond].a1 == atom ? bonds[bond].a2 : bonds[bond].a1;
  }
};

// ------------------------------------------------------------- SMILES parse

struct ParseError {};

bool is_two_letter(const std::string& s, size_t i) {
  return i + 1 < s.size() &&
         ((s[i] == 'C' && s[i + 1] == 'l') || (s[i] == 'B' && s[i + 1] == 'r'));
}

Atom parse_bracket(const std::string& body) {
  size_t i = 0, n = body.size();
  Atom a;
  a.explicit_h = 0;
  int isotope = 0;
  while (i < n && isdigit(body[i])) isotope = isotope * 10 + (body[i++] - '0');
  a.isotope = isotope;
  if (i >= n) throw ParseError{};
  if (body[i] == '*') {
    a.z = 0;
    i++;
  } else {
    std::string sym;
    if (isupper(body[i])) {
      sym += body[i++];
      if (i < n && islower(body[i]) && body[i] != 'h') {
        std::string two = sym + body[i];
        if (kSymbolToNum.count(two)) { sym = two; i++; }
      }
    } else if (islower(body[i])) {
      a.aromatic = true;
      sym += (char)toupper(body[i++]);
      // two-letter aromatic (se, as)
      if (i < n && islower(body[i]) && body[i] != 'h' && body[i] != 'r' &&
          body[i] != 'l') {
        std::string two = sym + body[i];
        if (kSymbolToNum.count(two)) { sym = two; i++; }
      }
    } else {
      throw ParseError{};
    }
    auto it = kSymbolToNum.find(sym);
    if (it == kSymbolToNum.end()) throw ParseError{};
    a.z = it->second;
  }
  if (i < n && body[i] == '@') {
    if (i + 1 < n && body[i + 1] == '@') { a.chiral = 1; i += 2; }
    else { a.chiral = 2; i++; }
    while (i < n && isupper(body[i]) && body[i] != 'H') i++;
  }
  if (i < n && body[i] == 'H') {
    i++;
    int h = 1;
    if (i < n && isdigit(body[i])) {
      h = 0;
      while (i < n && isdigit(body[i])) h = h * 10 + (body[i++] - '0');
    }
    a.explicit_h = h;
  }
  while (i < n && (body[i] == '+' || body[i] == '-')) {
    int sign = body[i] == '+' ? 1 : -1;
    i++;
    if (i < n && isdigit(body[i])) {
      int c = 0;
      while (i < n && isdigit(body[i])) c = c * 10 + (body[i++] - '0');
      a.charge += sign * c;
    } else {
      a.charge += sign;
    }
  }
  if (i < n && body[i] == ':') {
    i++;
    int map = 0;
    bool has = false;
    while (i < n && isdigit(body[i])) { map = map * 10 + (body[i++] - '0'); has = true; }
    // mirror chem/smiles.py:328-343: the colon requires at least one
    // digit ("[O:]" is a syntax error, like RDKit); a map of 0 is
    // treated as "no map"
    if (!has) throw ParseError{};
    if (map != 0) a.map = map;
  }
  if (i != n) throw ParseError{};
  return a;
}

// semantic neighbour order entries for chirality parity:
// >=0 atom id, -1 bracket-H, -(100+num) unresolved ring placeholder
struct SemOrder {
  std::map<int, std::vector<int>> order;
};

Mol parse_smiles_raw(const std::string& s, SemOrder* sem = nullptr) {
  Mol m;
  int prev = -1;
  char pending = 0;
  std::vector<std::pair<int, char>> stack;
  std::map<int, std::pair<int, char>> rings;
  size_t i = 0, n = s.size();

  auto decode = [&](char sym, int& order, int& dir, bool& arom) {
    order = -1; dir = 0; arom = false;
    if (!sym) return;
    switch (sym) {
      case '-': order = ORDER_SINGLE; break;
      case '=': order = ORDER_DOUBLE; break;
      case '#': order = ORDER_TRIPLE; break;
      case ':': order = ORDER_AROMATIC; arom = true; break;
      case '/': order = ORDER_SINGLE; dir = 1; break;
      case '\\': order = ORDER_SINGLE; dir = -1; break;
      default: throw ParseError{};
    }
  };

  auto attach = [&](int na) {
    if (prev >= 0) {
      int order, dir; bool arom;
      decode(pending, order, dir, arom);
      if (order < 0) {
        if (m.atoms[prev].aromatic && m.atoms[na].aromatic) {
          order = ORDER_AROMATIC; arom = true;
        } else {
          order = ORDER_SINGLE;
        }
      }
      m.add_bond(prev, na, order, arom, dir);
      if (sem) {
        sem->order[prev].push_back(na);
        sem->order[na].push_back(prev);
      }
    }
    if (sem && m.atoms[na].chiral && m.atoms[na].explicit_h >= 1)
      sem->order[na].push_back(-1);  // bracket H slot
    prev = na;
    pending = 0;
  };

  auto ring = [&](int num) {
    if (prev < 0) throw ParseError{};
    auto it = rings.find(num);
    if (it == rings.end()) {
      rings[num] = {prev, pending};
      if (sem) sem->order[prev].push_back(-(100 + num));
      pending = 0;
      return;
    }
    int a_open = it->second.first;
    char sym = pending ? pending : it->second.second;
    rings.erase(it);
    int order, dir; bool arom;
    decode(sym, order, dir, arom);
    if (order < 0) {
      if (m.atoms[a_open].aromatic && m.atoms[prev].aromatic) {
        order = ORDER_AROMATIC; arom = true;
      } else {
        order = ORDER_SINGLE;
      }
    }
    if (a_open == prev) throw ParseError{};
    m.add_bond(a_open, prev, order, arom, dir);
    if (sem) {
      // resolve the opener's placeholder; record at closure position
      auto& so = sem->order[a_open];
      for (auto& e : so)
        if (e == -(100 + num)) { e = prev; break; }
      sem->order[prev].push_back(a_open);
    }
    pending = 0;
  };

  while (i < n) {
    char c = s[i];
    if (c == '-' || c == '=' || c == '#' || c == ':' || c == '/' ||
        c == '\\' || c == '$') {
      if (pending) throw ParseError{};
      pending = c;
      i++;
    } else if (c == '(') {
      stack.push_back({prev, pending});
      pending = 0;
      i++;
    } else if (c == ')') {
      if (stack.empty()) throw ParseError{};
      prev = stack.back().first;
      pending = stack.back().second;
      stack.pop_back();
      i++;
    } else if (c == '.') {
      prev = -1; pending = 0; i++;
    } else if (c == '%') {
      if (i + 2 >= n || !isdigit(s[i + 1]) || !isdigit(s[i + 2]))
        throw ParseError{};
      ring((s[i + 1] - '0') * 10 + (s[i + 2] - '0'));
      i += 3;
    } else if (isdigit(c)) {
      ring(c - '0');
      i++;
    } else if (c == '[') {
      size_t j = s.find(']', i);
      if (j == std::string::npos) throw ParseError{};
      attach(m.add_atom(parse_bracket(s.substr(i + 1, j - i - 1))));
      i = j + 1;
    } else if (c == '*') {
      Atom a; a.z = 0; a.explicit_h = 0;
      attach(m.add_atom(a));
      i++;
    } else {
      Atom a;
      std::string sym;
      if (is_two_letter(s, i)) { sym = s.substr(i, 2); i += 2; }
      else {
        char u = toupper(c);
        if (std::string("BCNOPSFI").find(u) == std::string::npos)
          throw ParseError{};
        sym = std::string(1, u);
        a.aromatic = islower(c);
        if (a.aromatic && std::string("bcnops").find(c) == std::string::npos)
          throw ParseError{};
        i++;
      }
      auto it = kSymbolToNum.find(sym);
      if (it == kSymbolToNum.end()) throw ParseError{};
      a.z = it->second;
      attach(m.add_atom(a));
    }
  }
  if (!rings.empty() || !stack.empty() || m.atoms.empty()) throw ParseError{};
  return m;
}

// --------------------------------------------------------------- perception

void fold_explicit_h(Mol& m) {
  bool changed = true;
  while (changed) {
    changed = false;
    for (int a = 0; a < (int)m.atoms.size(); a++) {
      if (m.atoms[a].z == 1 && m.atoms[a].isotope == 0 &&
          m.atoms[a].charge == 0 && m.adj[a].size() == 1) {
        int b = m.adj[a][0];
        if (m.bonds[b].order != ORDER_SINGLE) continue;
        int heavy = m.other(b, a);
        if (m.atoms[heavy].z <= 1) continue;
        if (m.atoms[heavy].explicit_h >= 0) m.atoms[heavy].explicit_h++;
        // rebuild without atom a / bond b
        Mol nm;
        std::vector<int> remap(m.atoms.size(), -1);
        for (int x = 0; x < (int)m.atoms.size(); x++)
          if (x != a) remap[x] = nm.add_atom(m.atoms[x]);
        for (auto& bd : m.bonds)
          if (bd.a1 != a && bd.a2 != a)
            nm.add_bond(remap[bd.a1], remap[bd.a2], bd.order, bd.aromatic,
                        bd.direction);
        m = nm;
        changed = true;
        break;
      }
    }
  }
}

void perceive_rings(Mol& m) {
  int n = (int)m.atoms.size();
  std::vector<int> disc(n, -1), low(n, 0);
  std::vector<bool> bridge(m.bonds.size(), false);
  int timer = 0;
  // iterative DFS
  for (int root = 0; root < n; root++) {
    if (disc[root] != -1) continue;
    std::vector<std::tuple<int, int, size_t>> st;  // node, parent edge, iter
    st.push_back({root, -1, 0});
    disc[root] = low[root] = timer++;
    while (!st.empty()) {
      auto& [u, pe, it] = st.back();
      if (it < m.adj[u].size()) {
        int bi = m.adj[u][it++];
        if (bi == pe) continue;
        int v = m.other(bi, u);
        if (disc[v] == -1) {
          disc[v] = low[v] = timer++;
          st.push_back({v, bi, 0});
        } else {
          low[u] = std::min(low[u], disc[v]);
        }
      } else {
        int uu = u, ppe = pe;
        st.pop_back();
        if (!st.empty()) {
          int p = std::get<0>(st.back());
          low[p] = std::min(low[p], low[uu]);
          if (low[uu] > disc[p]) bridge[ppe] = true;
        }
      }
    }
  }
  for (size_t b = 0; b < m.bonds.size(); b++) m.bonds[b].in_ring = !bridge[b];
  for (int a = 0; a < n; a++) {
    m.atoms[a].in_ring = false;
    for (int bi : m.adj[a])
      if (m.bonds[bi].in_ring) { m.atoms[a].in_ring = true; break; }
  }
}

int lone_pairs(const Mol& m, int a, bool kekulized = false) {
  const Atom& at = m.atoms[a];
  if (at.z == 0) return 0;
  double bo = at.num_h;
  for (int bi : m.adj[a]) {
    int o = m.bonds[bi].order;
    if (kekulized && o == ORDER_AROMATIC)
      bo += m.bonds[bi].kekule;
    else
      bo += (o == ORDER_AROMATIC || o == ORDER_SINGLE) ? 1 : o;
  }
  int ve = outer_electrons(at.z) - at.charge;
  int lp = (ve - (int)bo) / 2;
  return lp > 0 ? lp : 0;
}

void assign_prelim_h(Mol& m) {
  for (int a = 0; a < (int)m.atoms.size(); a++) {
    Atom& at = m.atoms[a];
    if (at.explicit_h >= 0) { at.num_h = at.explicit_h; continue; }
    if (at.z == 0) { at.num_h = 0; continue; }
    auto vals = default_valence(at.z, at.charge);
    if (vals.empty()) { at.num_h = 0; continue; }
    int bo = 0;
    for (int bi : m.adj[a]) {
      int o = m.bonds[bi].order;
      bo += (o == ORDER_AROMATIC) ? 1 : o;
    }
    if (at.aromatic) {
      int target = vals.back();
      for (int v : vals) if (v >= bo) { target = v; break; }
      if (target - bo >= 1) bo += 1;  // pi-capable aromatic atom
    }
    int nh = 0;
    for (int v : vals) if (bo <= v) { nh = v - bo; break; }
    at.num_h = nh;
  }
}

// SSSR-lite: shortest cycle through each ring bond (for aromaticity of
// Kekulé-form input)
std::vector<std::vector<int>> sssr(const Mol& m) {
  std::vector<std::vector<int>> rings;
  std::set<std::set<int>> seen;
  std::set<int> covered;
  for (size_t bi = 0; bi < m.bonds.size(); bi++) {
    if (!m.bonds[bi].in_ring || covered.count((int)bi)) continue;
    // BFS shortest path a1->a2 avoiding bond bi over ring bonds
    int src = m.bonds[bi].a1, dst = m.bonds[bi].a2;
    std::map<int, int> prev;
    prev[src] = -1;
    std::vector<int> q = {src};
    bool found = false;
    for (size_t qi = 0; qi < q.size() && !found; qi++) {
      int u = q[qi];
      if (u == dst) { found = true; break; }
      for (int b2 : m.adj[u]) {
        if ((int)b2 == (int)bi || !m.bonds[b2].in_ring) continue;
        int v = m.other(b2, u);
        if (!prev.count(v)) { prev[v] = u; q.push_back(v); }
      }
    }
    if (!prev.count(dst)) continue;
    std::vector<int> ring;
    for (int u = dst; u != -1; u = prev[u]) ring.push_back(u);
    std::set<int> key(ring.begin(), ring.end());
    if (!seen.count(key)) {
      seen.insert(key);
      rings.push_back(ring);
      for (size_t k = 0; k < ring.size(); k++) {
        int u = ring[k], v = ring[(k + 1) % ring.size()];
        for (int b2 : m.adj[u])
          if (m.other(b2, u) == v) covered.insert(b2);
      }
    }
  }
  return rings;
}

void perceive_aromaticity(Mol& m) {
  assign_prelim_h(m);
  for (auto& ring : sssr(m)) {
    if (ring.size() < 5 || ring.size() > 7) continue;
    std::set<int> rs(ring.begin(), ring.end());
    int total = 0;
    bool ok = true;
    for (int a : ring) {
      const Atom& at = m.atoms[a];
      if (at.z == 0) continue;
      // sp2 sigma framework required (excludes in-ring sulfone S etc.)
      if ((int)m.adj[a].size() + at.num_h > 3) { ok = false; break; }
      int dbl_in = 0, dbl_out = 0;
      for (int bi : m.adj[a]) {
        int o = m.bonds[bi].order;
        if (o == ORDER_TRIPLE) { ok = false; break; }
        if (o == ORDER_DOUBLE || o == ORDER_AROMATIC) {
          if (rs.count(m.other(bi, a))) dbl_in++;
          else dbl_out++;
        }
      }
      if (!ok) break;
      if (dbl_in >= 1) total += 1;
      else if (dbl_out >= 1) total += 0;
      else if (lone_pairs(m, a) > 0) total += 2;
      else if (at.z == 6 && at.charge == 1) total += 0;
      else if (at.z == 6 && at.charge == -1) total += 2;
      else { ok = false; break; }
    }
    if (!ok || total % 4 != 2) continue;
    for (int a : ring) m.atoms[a].aromatic = true;
    for (size_t k = 0; k < ring.size(); k++) {
      int u = ring[k], v = ring[(k + 1) % ring.size()];
      for (int bi : m.adj[u])
        if (m.other(bi, u) == v) {
          Bond& b = m.bonds[bi];
          b.aromatic = true;
          if (b.order == ORDER_SINGLE || b.order == ORDER_DOUBLE)
            b.order = ORDER_AROMATIC;
        }
    }
  }
}

// RDKit-style static pi-electron donor on the kekulized structure
// (mirrors chem/mol.py Molecule._electron_donor): cyclic multiple bond ->
// 1; exocyclic double to heteroatom -> 0 (vacant); exocyclic double to C
// -> -1 (blocker, fulvene); lone pair -> 2; C+ -> 0, C- -> 2; else -1.
int electron_donor(const Mol& m, int a) {
  const Atom& at = m.atoms[a];
  if (at.z == 0) return 0;
  if ((int)m.adj[a].size() + at.num_h > 3) return -1;
  int cyc_mult = 0, exo_het = 0, exo_c = 0;
  for (int bi : m.adj[a]) {
    const Bond& b = m.bonds[bi];
    int o = (b.order == ORDER_AROMATIC) ? b.kekule : b.order;
    if (o == ORDER_DOUBLE || o == ORDER_TRIPLE) {
      if (b.in_ring) cyc_mult++;
      else if (m.atoms[m.other(bi, a)].z == 6) exo_c++;
      else exo_het++;
    }
  }
  if (exo_c) return -1;
  if (cyc_mult) return 1;
  if (exo_het) return 0;
  if (lone_pairs(m, a, true) > 0) return 2;
  if (at.z == 6 && at.charge == 1) return 0;
  if (at.z == 6 && at.charge == -1) return 2;
  return -1;
}

// Authoritative post-kekulization aromaticity (chem/mol.py
// Molecule._reperceive_aromaticity): per-ring Hückel over static donors,
// union rescue of fused failed rings (azulene) with vacant-donor unions
// rejected (keeps actinomycin's phenoxazinone at 1 aromatic ring), then
// promotion/demotion against the written flags. kekule orders preserved.
void reperceive_aromaticity(Mol& m) {
  std::vector<std::vector<int>> rings;
  for (auto& r : sssr(m))
    if (r.size() >= 5 && r.size() <= 7) rings.push_back(r);
  if (rings.empty()) return;
  std::map<int, int> donors;
  auto ring_bond_ids = [&](const std::vector<int>& ring) {
    std::vector<int> out;
    for (size_t k = 0; k < ring.size(); k++) {
      int u = ring[k], v = ring[(k + 1) % ring.size()];
      for (int bi : m.adj[u])
        if (m.other(bi, u) == v) out.push_back(bi);
    }
    return out;
  };
  for (auto& r : rings)
    for (int a : r)
      if (!donors.count(a)) donors[a] = electron_donor(m, a);
  std::set<int> arom_atoms, arom_bonds;
  auto accept = [&](const std::vector<int>& ring) {
    for (int a : ring) arom_atoms.insert(a);
    for (int bi : ring_bond_ids(ring)) arom_bonds.insert(bi);
  };
  std::vector<std::vector<int>> pending;
  for (auto& ring : rings) {
    int total = 0;
    bool blocked = false;
    for (int a : ring) {
      if (donors[a] < 0) { blocked = true; break; }
      total += donors[a];
    }
    if (blocked) continue;
    if (total % 4 == 2) accept(ring);
    else pending.push_back(ring);
  }
  // union rescue over connected subsets (size 2..4) of failed rings
  if (pending.size() >= 2) {
    std::vector<std::set<int>> rbonds;
    for (auto& r : pending) {
      auto ids = ring_bond_ids(r);
      rbonds.push_back(std::set<int>(ids.begin(), ids.end()));
    }
    std::vector<bool> done(pending.size(), false);
    int n = (int)pending.size();
    for (int size = 2; size <= 4 && size <= n; size++) {
      std::vector<int> combo(size);
      std::function<void(int, int)> rec = [&](int start, int k) {
        for (int i = start; i < n; i++) {
          combo[k] = i;
          if (k + 1 < size) { rec(i + 1, k + 1); continue; }
          bool skip = false;
          for (int j : combo) if (done[j]) { skip = true; break; }
          if (skip) continue;
          // connectivity via shared bonds
          std::set<int> grown = {combo[0]}, rest(combo.begin() + 1,
                                                 combo.end());
          bool grew = true;
          while (grew && !rest.empty()) {
            grew = false;
            for (auto it = rest.begin(); it != rest.end();) {
              bool touch = false;
              for (int k2 : grown)
                for (int bid : rbonds[*it])
                  if (rbonds[k2].count(bid)) { touch = true; break; }
              if (touch) { grown.insert(*it); it = rest.erase(it);
                           grew = true; }
              else ++it;
            }
          }
          if (!rest.empty()) continue;
          std::set<int> uni;
          for (int j : combo) uni.insert(pending[j].begin(),
                                         pending[j].end());
          int total = 0;
          bool bad = false;
          for (int a : uni) {
            if (donors[a] <= 0) { bad = true; break; }  // vacant blocks
            total += donors[a];
          }
          if (bad || total % 4 != 2) continue;
          for (int j : combo) { accept(pending[j]); done[j] = true; }
        }
      };
      rec(0, 0);
    }
  }
  // reconcile with written flags (scope: the 5-7 rings examined)
  std::set<int> scope_bonds, scope_atoms;
  for (auto& r : rings) {
    for (int bi : ring_bond_ids(r)) scope_bonds.insert(bi);
    for (int a : r) scope_atoms.insert(a);
  }
  for (int bi : scope_bonds) {
    Bond& b = m.bonds[bi];
    if (arom_bonds.count(bi)) {
      if (!b.aromatic) {
        b.aromatic = true;
        if (b.order == ORDER_SINGLE || b.order == ORDER_DOUBLE) {
          b.kekule = b.order;
          b.order = ORDER_AROMATIC;
        }
      }
    } else if (b.aromatic) {
      b.aromatic = false;
      if (b.order == ORDER_AROMATIC) b.order = b.kekule;
    }
  }
  for (int ai : scope_atoms) {
    Atom& at = m.atoms[ai];
    if (arom_atoms.count(ai)) {
      at.aromatic = true;
    } else if (at.aromatic) {
      bool keep = false;
      for (int bi : m.adj[ai])
        if (m.bonds[bi].aromatic) { keep = true; break; }
      at.aromatic = keep;
    }
  }
}

bool kekulize(Mol& m) {
  for (auto& b : m.bonds)
    b.kekule = (b.order == ORDER_AROMATIC) ? ORDER_SINGLE : b.order;
  std::vector<int> role(m.atoms.size(), 0);  // 0 none, 1 required, 2 optional
  bool any = false;
  for (int a = 0; a < (int)m.atoms.size(); a++) {
    const Atom& at = m.atoms[a];
    if (!at.aromatic || at.z == 0) continue;
    auto vals = default_valence(at.z, at.charge);
    if (vals.empty()) continue;
    int used = at.num_h;
    for (int bi : m.adj[a]) {
      int o = m.bonds[bi].order;
      used += (o == ORDER_AROMATIC) ? 1 : o;
    }
    int target = vals.back();
    for (int v : vals) if (v >= used) { target = v; break; }
    if (target - used < 1) continue;
    role[a] = (at.z == 6 && at.charge != 0) ? 2 : 1;
    any = true;
  }
  if (!any) return true;
  // greedy augmenting matching over aromatic bonds between eligible atoms
  std::vector<int> match(m.atoms.size(), -1);
  std::vector<std::vector<int>> eadj(m.atoms.size());
  for (size_t bi = 0; bi < m.bonds.size(); bi++) {
    const Bond& b = m.bonds[bi];
    if (b.order == ORDER_AROMATIC && role[b.a1] && role[b.a2]) {
      eadj[b.a1].push_back((int)bi);
      eadj[b.a2].push_back((int)bi);
    }
  }
  std::function<bool(int, std::set<int>&)> augment =
      [&](int u, std::set<int>& vis) -> bool {
    for (int bi : eadj[u]) {
      int v = m.other(bi, u);
      if (vis.count(v)) continue;
      vis.insert(v);
      if (match[v] < 0 || augment(match[v], vis)) {
        match[u] = v;
        match[v] = u;
        return true;
      }
    }
    return false;
  };
  bool all_ok = true;
  for (int a = 0; a < (int)m.atoms.size(); a++) {
    if (role[a] == 1 && match[a] < 0) {
      std::set<int> vis{a};
      if (!augment(a, vis)) all_ok = false;
    }
  }
  for (auto& b : m.bonds)
    if (b.order == ORDER_AROMATIC && match[b.a1] == b.a2)
      b.kekule = ORDER_DOUBLE;
  return all_ok;
}

void assign_final_h(Mol& m) {
  for (int a = 0; a < (int)m.atoms.size(); a++) {
    Atom& at = m.atoms[a];
    if (at.explicit_h >= 0) { at.num_h = at.explicit_h; continue; }
    if (at.z == 0) { at.num_h = 0; continue; }
    auto vals = default_valence(at.z, at.charge);
    if (vals.empty()) { at.num_h = 0; continue; }
    int bo = 0;
    for (int bi : m.adj[a]) {
      const Bond& b = m.bonds[bi];
      bo += (b.order == ORDER_AROMATIC) ? b.kekule : b.order;
    }
    int nh = 0;
    for (int v : vals) if (bo <= v) { nh = v - bo; break; }
    at.num_h = nh;
  }
}

void assign_hybridization(Mol& m) {
  for (int a = 0; a < (int)m.atoms.size(); a++) {
    Atom& at = m.atoms[a];
    if (at.z == 0) { at.hyb = -1; continue; }
    if (at.z == 1) { at.hyb = -1; continue; }
    if (default_valence(at.z, at.charge).empty()) {
      at.hyb = -1;  // metals etc.: RDKit S/UNSPECIFIED -> unknown slot
      continue;
    }
    if (at.aromatic) { at.hyb = 1; continue; }  // SP2
    // pure steric-number rule (no multiple-bond shortcuts: hypervalent
    // S/N — sulfonamide S is SP3, nitro N is SP2)
    int sigma = (int)m.adj[a].size() + at.num_h;
    int steric = sigma + lone_pairs(m, a);
    if (steric <= 2) at.hyb = 0;
    else if (steric == 3) at.hyb = 1;
    else if (steric == 4) at.hyb = 2;
    else if (steric == 5) at.hyb = 3;
    else at.hyb = 4;
  }
}

bool pi_center(const Mol& m, int a) {
  const Atom& at = m.atoms[a];
  if (at.z == 0) return false;
  for (int bi : m.adj[a]) {
    int o = m.bonds[bi].order;
    if (o == ORDER_DOUBLE || o == ORDER_TRIPLE || o == ORDER_AROMATIC ||
        m.bonds[bi].aromatic)
      return true;
  }
  return (at.z == 7 || at.z == 8 || at.z == 16 || at.z == 15) &&
         lone_pairs(m, a) > 0;
}

void assign_conjugation(Mol& m) {
  // RDKit-style pair marking: around every atom, a multiple/aromatic bond
  // b1 and a sibling bond b2 whose far end is a pi center are both
  // conjugated. Isolated multiple bonds stay unconjugated.
  for (auto& b : m.bonds)
    b.conjugated = (b.order == ORDER_AROMATIC || b.aromatic);
  for (int a = 0; a < (int)m.atoms.size(); a++) {
    const auto& bonds = m.adj[a];
    if (bonds.size() < 2) continue;
    for (int b1 : bonds) {
      int o1 = m.bonds[b1].order;
      if (!(o1 == ORDER_DOUBLE || o1 == ORDER_TRIPLE ||
            o1 == ORDER_AROMATIC || m.bonds[b1].aromatic))
        continue;
      for (int b2 : bonds) {
        if (b2 == b1) continue;
        if (pi_center(m, m.other(b2, a))) {
          m.bonds[b1].conjugated = true;
          m.bonds[b2].conjugated = true;
        }
      }
    }
  }
}

// --- CIP branch comparison (mirrors chem/stereo.py) ---------------------

constexpr int CIP_DEPTH = 12;

std::vector<std::vector<int>> branch_levels(const Mol& m, int root,
                                            int first) {
  std::vector<std::vector<int>> levels;
  levels.push_back({m.atoms[first].z});
  std::set<int> visited{root, first};
  std::vector<std::pair<int, int>> frontier{{first, root}};
  for (int d = 0; d < CIP_DEPTH; d++) {
    std::vector<std::pair<int, int>> nxt;
    std::vector<int> level;
    for (auto& [a, parent] : frontier) {
      for (int bi : m.adj[a]) {
        const Bond& b = m.bonds[bi];
        int o = m.other(bi, a);
        int mult = 0;
        if (b.order == ORDER_DOUBLE) mult = 1;
        else if (b.order == ORDER_TRIPLE) mult = 2;
        else if ((b.order == ORDER_AROMATIC || b.aromatic) &&
                 b.kekule == ORDER_DOUBLE) mult = 1;
        if (o == parent) {
          for (int k = 0; k < mult; k++) level.push_back(m.atoms[parent].z);
          continue;
        }
        level.push_back(m.atoms[o].z);
        for (int k = 0; k < mult; k++) level.push_back(m.atoms[o].z);
        if (!visited.count(o)) {
          visited.insert(o);
          nxt.push_back({o, a});
        }
      }
    }
    for (auto& [a, parent] : frontier)
      for (int k = 0; k < m.atoms[a].num_h; k++) level.push_back(1);
    if (level.empty()) break;
    std::sort(level.rbegin(), level.rend());
    levels.push_back(level);
    frontier = nxt;
    if (frontier.empty()) break;
  }
  // sort level 0 too (single element, no-op) for parity with python
  return levels;
}

int compare_branches(const Mol& m, int root, int a, int b) {
  if (a == b) return 0;
  auto la = branch_levels(m, root, a);
  auto lb = branch_levels(m, root, b);
  size_t n = std::max(la.size(), lb.size());
  for (size_t i = 0; i < n; i++) {
    static const std::vector<int> empty;
    const auto& va = i < la.size() ? la[i] : empty;
    const auto& vb = i < lb.size() ? lb[i] : empty;
    if (va != vb) return va > vb ? 1 : -1;
  }
  return 0;
}

// highest-priority neighbour of atom (excluding `exclude`); tie -> -2
int high_priority_neighbor(const Mol& m, int atom, int exclude) {
  std::vector<int> nbrs;
  for (int bi : m.adj[atom]) {
    int o = m.other(bi, atom);
    if (o != exclude) nbrs.push_back(o);
  }
  if (nbrs.empty()) return -1;
  if (nbrs.size() == 1) return nbrs[0];
  int c = compare_branches(m, atom, nbrs[0], nbrs[1]);
  if (c == 0) return -2;
  return c > 0 ? nbrs[0] : nbrs[1];
}

void assign_stereo(Mol& m) {
  for (auto& b : m.bonds) {
    b.stereo = 0;
    if (b.order != ORDER_DOUBLE || b.in_ring) continue;
    int n1 = -1, d1 = 0, n2 = -1, d2 = 0;
    for (int bi : m.adj[b.a1]) {
      const Bond& bb = m.bonds[bi];
      if (&bb != &b && bb.direction != 0 && bb.order == ORDER_SINGLE) {
        n1 = bi; d1 = bb.direction; break;
      }
    }
    for (int bi : m.adj[b.a2]) {
      const Bond& bb = m.bonds[bi];
      if (&bb != &b && bb.direction != 0 && bb.order == ORDER_SINGLE) {
        n2 = bi; d2 = bb.direction; break;
      }
    }
    if (n1 < 0 || n2 < 0) continue;
    int marked1 = m.other(n1, b.a1);
    int marked2 = m.other(n2, b.a2);
    int s1 = (m.bonds[n1].a1 == b.a1) ? d1 : -d1;
    int s2 = (m.bonds[n2].a1 == b.a2) ? d2 : -d2;
    int hi1 = high_priority_neighbor(m, b.a1, b.a2);
    int hi2 = high_priority_neighbor(m, b.a2, b.a1);
    if (hi1 == -2 || hi2 == -2) continue;  // not stereogenic
    if (hi1 < 0) hi1 = marked1;
    if (hi2 < 0) hi2 = marked2;
    if (hi1 != marked1) s1 = -s1;
    if (hi2 != marked2) s2 = -s2;
    b.stereo = (s1 == s2) ? 2 : 3;  // STEREOZ : STEREOE
  }
  // clear chiral tags on non-stereocenters (RDKit cleanIt=true)
  for (int ai = 0; ai < (int)m.atoms.size(); ai++) {
    Atom& at = m.atoms[ai];
    if (at.chiral == 0) continue;
    std::vector<int> nbrs;
    for (int bi : m.adj[ai]) nbrs.push_back(m.other(bi, ai));
    int n_branches = (int)nbrs.size() + at.num_h;
    if ((n_branches < 4 && !(nbrs.size() == 3 && at.num_h == 0)) ||
        at.num_h > 1) {
      at.chiral = 0;
      continue;
    }
    bool distinguishable = true;
    for (size_t i = 0; i < nbrs.size() && distinguishable; i++)
      for (size_t j = i + 1; j < nbrs.size(); j++)
        if (compare_branches(m, ai, nbrs[i], nbrs[j]) == 0) {
          distinguishable = false;
          break;
        }
    if (!distinguishable) at.chiral = 0;
  }
}

int perm_parity(const std::vector<int>& from, const std::vector<int>& to) {
  std::map<int, int> pos;
  for (size_t i = 0; i < to.size(); i++) pos[to[i]] = (int)i;
  std::vector<int> perm;
  for (int v : from) {
    auto it = pos.find(v);
    if (it == pos.end()) return -1;
    perm.push_back(it->second);
  }
  int parity = 0;
  std::vector<bool> seen(perm.size(), false);
  for (size_t i = 0; i < perm.size(); i++) {
    if (seen[i]) continue;
    size_t j = i; int clen = 0;
    while (!seen[j]) { seen[j] = true; j = perm[j]; clen++; }
    parity ^= (clen - 1) & 1;
  }
  return parity;
}

void normalize_chirality(Mol& m, const SemOrder& sem) {
  for (int ai = 0; ai < (int)m.atoms.size(); ai++) {
    Atom& at = m.atoms[ai];
    if (at.chiral != 1 && at.chiral != 2) continue;
    auto it = sem.order.find(ai);
    if (it == sem.order.end()) continue;
    std::vector<int> written = it->second;
    std::vector<int> mol_order;
    for (int bi : m.adj[ai]) mol_order.push_back(m.other(bi, ai));
    if (at.explicit_h >= 1) mol_order.push_back(-1);
    if (written.size() != mol_order.size() ||
        (written.size() != 3 && written.size() != 4))
      continue;
    int p = perm_parity(written, mol_order);
    if (p < 0) continue;
    if (p) at.chiral = (at.chiral == 1) ? 2 : 1;
  }
}

// RDKit MolOps::cleanUp equivalent for nitrogen (chem/mol.py
// _cleanup_hypervalent_nitrogen): hypervalent neutral N written as nitro
// N(=O)=O / N-oxide n=O / azide N=N=N is charge-separated the way RDKit
// sanitization does ([N+](=O)[O-], [n+][O-], N=[N+]=[N-]).
void cleanup_hypervalent_nitrogen(Mol& m) {
  for (int ai = 0; ai < (int)m.atoms.size(); ai++) {
    Atom& at = m.atoms[ai];
    if (at.z != 7 || at.charge != 0) continue;
    double bos = 0.0;
    for (int bi : m.adj[ai])
      bos += m.bonds[bi].order == ORDER_AROMATIC ? 1.5 : m.bonds[bi].order;
    if (at.explicit_h > 0) bos += at.explicit_h;
    if (bos <= 3.0) continue;
    bool done = false;
    for (int bi : m.adj[ai]) {
      Bond& b = m.bonds[bi];
      int oi = m.other(bi, ai);
      Atom& o = m.atoms[oi];
      if (b.order == ORDER_DOUBLE && o.z == 8 && o.charge == 0 &&
          m.adj[oi].size() == 1) {
        b.order = ORDER_SINGLE;
        o.charge = -1;
        at.charge = 1;
        done = true;
        break;
      }
    }
    if (done) continue;
    for (int bi : m.adj[ai]) {
      Bond& b = m.bonds[bi];
      int oi = m.other(bi, ai);
      Atom& o = m.atoms[oi];
      if (b.order == ORDER_DOUBLE && o.z == 7 && o.charge == 0 &&
          m.adj[oi].size() == 1) {
        o.charge = -1;
        at.charge = 1;
        break;
      }
    }
  }
}

bool perceive(Mol& m, bool keep_h = false) {
  if (!keep_h) fold_explicit_h(m);
  cleanup_hypervalent_nitrogen(m);
  perceive_rings(m);
  perceive_aromaticity(m);
  bool ok = kekulize(m);
  reperceive_aromaticity(m);
  assign_final_h(m);
  assign_hybridization(m);
  assign_conjugation(m);
  assign_stereo(m);
  return ok;
}

// AddHs equivalent (chem/smiles.py:_materialize_hs, reference make_mol
// add-H path rdkit.py:13-16): implicit hydrogens become explicit graph
// atoms appended in atom order, then the molecule is re-perceived exactly
// like the Python path's second mol.perceive() call.
bool materialize_hs(Mol& m) {
  int n = (int)m.atoms.size();
  for (int a = 0; a < n; a++) {
    int nh = m.atoms[a].num_h;
    for (int k = 0; k < nh; k++) {
      Atom h;
      h.z = 1;
      h.explicit_h = 0;
      int hid = m.add_atom(h);
      m.add_bond(a, hid, ORDER_SINGLE, false, 0);
    }
    m.atoms[a].explicit_h = 0;
    m.atoms[a].num_h = 0;
  }
  return perceive(m, /*keep_h=*/true);
}

// ------------------------------------------------------------ featurization

void onek(int value, int n_choices, float* out) {
  // choices are 0..n_choices-1; slot n_choices = unknown
  for (int i = 0; i <= n_choices; i++) out[i] = 0.f;
  if (value >= 0 && value < n_choices) out[value] = 1.f;
  else out[n_choices] = 1.f;
}

void atom_features(const Mol& m, int a, float* out) {
  const Atom& at = m.atoms[a];
  float* p = out;
  onek(at.z - 1, 100, p); p += 101;
  int tdeg = (int)m.adj[a].size() + at.num_h;
  onek(tdeg <= 5 ? tdeg : -1, 6, p); p += 7;
  // formal charge choices [-1,-2,1,2,0]
  int ci;
  switch (at.charge) {
    case -1: ci = 0; break; case -2: ci = 1; break; case 1: ci = 2; break;
    case 2: ci = 3; break; case 0: ci = 4; break; default: ci = -1;
  }
  onek(ci, 5, p); p += 6;
  onek(at.chiral, 4, p); p += 5;
  onek(at.num_h <= 4 ? at.num_h : -1, 5, p); p += 6;
  onek(at.hyb, 5, p); p += 6;
  *p++ = at.aromatic ? 1.f : 0.f;
  double mass = at.isotope ? (double)at.isotope
                           : (at.z < 104 ? kMass[at.z] : at.z * 2.0);
  *p++ = (float)(mass * 0.01);
}

void bond_features(const Mol& m, int bi, float* out) {
  const Bond& b = m.bonds[bi];
  float* p = out;
  *p++ = 0.f;
  *p++ = (b.order == ORDER_SINGLE && !b.aromatic) ? 1.f : 0.f;
  *p++ = (b.order == ORDER_DOUBLE && !b.aromatic) ? 1.f : 0.f;
  *p++ = (b.order == ORDER_TRIPLE) ? 1.f : 0.f;
  *p++ = (b.order == ORDER_AROMATIC || b.aromatic) ? 1.f : 0.f;
  *p++ = b.conjugated ? 1.f : 0.f;
  *p++ = b.in_ring ? 1.f : 0.f;
  onek(b.stereo, 6, p);
}

// Packed per-molecule graph in the framework's MolGraph layout.
struct PackedGraph {
  int n_atoms = 0, n_bonds = 0;
  std::vector<float> f_atoms;   // n_atoms * 133
  std::vector<float> f_bonds;   // n_bonds * 147
  std::vector<int> b2a, b2dst, b2revb;
  // standard mode: per-directed-bond LOCAL parse-order undirected bond
  // index (Mol bond-list order == the Python parser's bond.idx), for
  // aligning user per-bond extra-feature files; empty otherwise
  std::vector<int> b2parse;
  // polymer mode: per-atom stoichiometry weights, per-bond stochastic
  // weights, 1+log10(Xn); empty w vectors = all-unit (standard mode)
  std::vector<float> w_atoms, w_bonds;
  float degree_of_polym = 1.f;
  bool valid = false;
};

PackedGraph featurize_one(const std::string& smiles, bool keep_h = false,
                          bool add_h = false) {
  PackedGraph g;
  Mol m;
  try {
    SemOrder sem;
    m = parse_smiles_raw(smiles, &sem);
    normalize_chirality(m, sem);
    if (!perceive(m, keep_h)) return g;
    if (add_h && !materialize_hs(m)) return g;
  } catch (...) {
    return g;
  }
  g.n_atoms = (int)m.atoms.size();
  g.f_atoms.resize((size_t)g.n_atoms * ATOM_FDIM);
  for (int a = 0; a < g.n_atoms; a++)
    atom_features(m, a, &g.f_atoms[(size_t)a * ATOM_FDIM]);
  // bonds ordered by sorted (min, max) like the Python featurizer
  std::vector<int> order(m.bonds.size());
  for (size_t i = 0; i < m.bonds.size(); i++) order[i] = (int)i;
  std::sort(order.begin(), order.end(), [&](int x, int y) {
    int x1 = std::min(m.bonds[x].a1, m.bonds[x].a2);
    int x2 = std::max(m.bonds[x].a1, m.bonds[x].a2);
    int y1 = std::min(m.bonds[y].a1, m.bonds[y].a2);
    int y2 = std::max(m.bonds[y].a1, m.bonds[y].a2);
    return x1 != y1 ? x1 < y1 : x2 < y2;
  });
  g.n_bonds = 2 * (int)m.bonds.size();
  g.f_bonds.resize((size_t)g.n_bonds * (ATOM_FDIM + BOND_FDIM));
  g.b2a.resize(g.n_bonds);
  g.b2dst.resize(g.n_bonds);
  g.b2revb.resize(g.n_bonds);
  g.b2parse.resize(g.n_bonds);
  float fb[BOND_FDIM];
  int bid = 0;
  for (int bi : order) {
    int a1 = std::min(m.bonds[bi].a1, m.bonds[bi].a2);
    int a2 = std::max(m.bonds[bi].a1, m.bonds[bi].a2);
    bond_features(m, bi, fb);
    for (int dir = 0; dir < 2; dir++) {
      int src = dir == 0 ? a1 : a2;
      int dst = dir == 0 ? a2 : a1;
      float* row = &g.f_bonds[(size_t)bid * (ATOM_FDIM + BOND_FDIM)];
      std::memcpy(row, &g.f_atoms[(size_t)src * ATOM_FDIM],
                  ATOM_FDIM * sizeof(float));
      std::memcpy(row + ATOM_FDIM, fb, BOND_FDIM * sizeof(float));
      g.b2a[bid] = src;
      g.b2dst[bid] = dst;
      g.b2revb[bid] = dir == 0 ? bid + 1 : bid - 1;
      g.b2parse[bid] = bi;
      bid++;
    }
  }
  g.valid = true;
  return g;
}

// ------------------------------------------------------- polymer featurizer
// Mirrors features/featurization.py MolGraph._build_polymer (which itself
// mirrors reference featurization.py:489-637): wD-MPNN copolymer ensemble
// strings "monA.monB|w1|w2|<i-j:wij:wji...~Xn".

std::vector<std::string> split_str(const std::string& s, char sep) {
  std::vector<std::string> out;
  size_t start = 0;
  while (true) {
    size_t p = s.find(sep, start);
    if (p == std::string::npos) { out.push_back(s.substr(start)); break; }
    out.push_back(s.substr(start, p - start));
    start = p + 1;
  }
  return out;
}

double parse_float_strict(const std::string& s) {
  if (s.empty()) throw ParseError{};
  char* end = nullptr;
  double v = strtod(s.c_str(), &end);
  if (end != s.c_str() + s.size()) throw ParseError{};
  return v;
}

struct PolymerRule {
  std::string r1, r2;  // R-tag indices as written (string compare, like the
                       // Python f"*{r1}" lookup)
  double w12, w21;
};

// parse_polymer_rules (featurization.py:187-222): '<'-split rule tokens,
// optional '~Xn' on the last one. The reference's Σ-weights validation never
// fires (and ours is a warning), so it is skipped here.
void parse_polymer_rules(std::vector<std::string> rules,
                         std::vector<PolymerRule>* out, double* dop) {
  double xn = 1.0;
  if (!rules.empty()) {
    auto t = rules.back().find('~');
    if (t != std::string::npos) {
      xn = parse_float_strict(rules.back().substr(t + 1));
      rules.back() = rules.back().substr(0, t);
    }
  }
  if (xn <= 0.0) throw ParseError{};  // Python math.log10 raises
  for (const auto& rule : rules) {
    if (rule.empty()) continue;
    auto parts = split_str(rule, ':');
    if (parts.size() != 3) throw ParseError{};
    auto idx = split_str(parts[0], '-');
    if (idx.size() != 2) throw ParseError{};
    PolymerRule r;
    r.r1 = idx[0];
    r.r2 = idx[1];
    r.w12 = parse_float_strict(parts[1]);
    r.w21 = parse_float_strict(parts[2]);
    out->push_back(r);
  }
  *dop = 1.0 + std::log10(xn);
}

// make_polymer_mol (chem featurization.py:50-77 / reference rdkit.py:21-51):
// parse+perceive each '.'-fragment, stamp per-atom w_frag, combine, and
// re-perceive the combined molecule.
Mol make_polymer_mol(const std::string& frags_smiles,
                     const std::vector<double>& weights,
                     std::vector<double>* w_frag,
                     bool keep_h = false, bool add_h = false) {
  auto frags = split_str(frags_smiles, '.');
  if (frags.size() != weights.size()) throw ParseError{};
  Mol combined;
  for (size_t fi = 0; fi < frags.size(); fi++) {
    SemOrder sem;
    Mol f = parse_smiles_raw(frags[fi], &sem);
    normalize_chirality(f, sem);
    if (!perceive(f, keep_h)) throw ParseError{};  // strict fragment parse
    if (add_h && !materialize_hs(f)) throw ParseError{};
    int off = (int)combined.atoms.size();
    for (const Atom& a : f.atoms) {
      Atom na;
      na.z = a.z;
      na.charge = a.charge;
      na.aromatic = a.aromatic;   // fragment perception travels, like the
      na.chiral = a.chiral;       // Python Atom copy in make_polymer_mol
      na.isotope = a.isotope;
      na.explicit_h = a.explicit_h;
      na.map = a.map;
      combined.add_atom(na);
      w_frag->push_back(weights[fi]);
    }
    for (const Bond& b : f.bonds)
      combined.add_bond(b.a1 + off, b.a2 + off, b.order, b.aromatic,
                        b.direction);
  }
  if (!perceive(combined, /*keep_h=*/true)) throw ParseError{};
  return combined;
}

std::string r_tag_of(const Atom& a) {
  return a.map >= 0 ? "*" + std::to_string(a.map) : "*";
}

// _synthetic_bond_features (features/featurization.py:134-158): features of
// a stochastic inter-monomer bond as if added between two monomer copies —
// never in a ring, no stereo, not aromatic; conjugation by the pair-marking
// rule on the pruned mol.
void synthetic_bond_features(const Mol& m, int a1, int a2, int order,
                             float* out) {
  bool conj;
  auto has_multiple = [&](int a) {
    for (int bi : m.adj[a]) {
      int o = m.bonds[bi].order;
      if (o == ORDER_DOUBLE || o == ORDER_TRIPLE || o == ORDER_AROMATIC ||
          m.bonds[bi].aromatic)
        return true;
    }
    return false;
  };
  if (order == ORDER_DOUBLE || order == ORDER_TRIPLE) {
    conj = false;
    for (int nb : {a1, a2})
      for (int bi : m.adj[nb])
        if (pi_center(m, m.other(bi, nb))) { conj = true; break; }
  } else {
    conj = (has_multiple(a1) && pi_center(m, a2)) ||
           (has_multiple(a2) && pi_center(m, a1));
  }
  float* p = out;
  *p++ = 0.f;
  *p++ = (order == ORDER_SINGLE) ? 1.f : 0.f;
  *p++ = (order == ORDER_DOUBLE) ? 1.f : 0.f;
  *p++ = (order == ORDER_TRIPLE) ? 1.f : 0.f;
  *p++ = (order == ORDER_AROMATIC) ? 1.f : 0.f;
  *p++ = conj ? 1.f : 0.f;
  *p++ = 0.f;          // never in a ring
  onek(0, 6, p);       // STEREONONE
}

PackedGraph featurize_polymer_one(const std::string& input,
                                  bool keep_h = false, bool add_h = false) {
  PackedGraph g;
  try {
    auto fields = split_str(input, '|');
    std::vector<double> weights;
    for (size_t i = 1; i + 1 < fields.size(); i++)
      weights.push_back(parse_float_strict(fields[i]));
    auto lt_parts = split_str(input, '<');
    std::vector<std::string> rules(lt_parts.begin() + 1, lt_parts.end());
    std::vector<PolymerRule> pinfo;
    double dop = 1.0;
    parse_polymer_rules(rules, &pinfo, &dop);

    std::vector<double> w_frag;
    Mol m = make_polymer_mol(fields[0], weights, &w_frag, keep_h, add_h);

    // tag_atoms_in_repeating_unit (featurization.py:165-184): wildcard ->
    // its single neighbour; R-tag -> attachment bond order. Later entries
    // overwrite earlier ones (Python dict semantics).
    std::map<std::string, int> neighbor_map;
    std::map<std::string, int> r_bond_types;
    int n_all = (int)m.atoms.size();
    for (int a = 0; a < n_all; a++) {
      if (m.atoms[a].z != 0) continue;
      if (m.adj[a].size() != 1) throw ParseError{};  // Python assert
      std::string tag = r_tag_of(m.atoms[a]);
      neighbor_map[tag] = m.other(m.adj[a][0], a);
      r_bond_types[tag] = m.bonds[m.adj[a][0]].order;
    }

    // atom features computed WITH wildcards attached (correct saturation,
    // reference featurization.py:504-507); core atoms only, original order
    std::vector<int> core_remap(n_all, -1);
    int n_core = 0;
    for (int a = 0; a < n_all; a++)
      if (m.atoms[a].z != 0) core_remap[a] = n_core++;
    g.n_atoms = n_core;
    g.f_atoms.resize((size_t)n_core * ATOM_FDIM);
    g.w_atoms.resize(n_core);
    for (int a = 0; a < n_all; a++) {
      if (core_remap[a] < 0) continue;
      atom_features(m, a, &g.f_atoms[(size_t)core_remap[a] * ATOM_FDIM]);
      g.w_atoms[core_remap[a]] = (float)w_frag[a];
    }

    // attachment atoms in post-pruning indices
    std::map<std::string, int> attach;
    for (auto& kv : neighbor_map) attach[kv.first] = core_remap[kv.second];

    // remove wildcards (remove_wildcard_atoms, featurization.py:225-233)
    // and re-perceive the pruned molecule
    Mol pm;
    for (int a = 0; a < n_all; a++)
      if (core_remap[a] >= 0) {
        Atom na;
        const Atom& o = m.atoms[a];
        na.z = o.z; na.charge = o.charge; na.aromatic = o.aromatic;
        na.chiral = o.chiral; na.isotope = o.isotope;
        na.explicit_h = o.explicit_h; na.map = o.map;
        pm.add_atom(na);
      }
    for (const Bond& b : m.bonds)
      if (core_remap[b.a1] >= 0 && core_remap[b.a2] >= 0)
        pm.add_bond(core_remap[b.a1], core_remap[b.a2], b.order, b.aromatic,
                    b.direction);
    if (!perceive(pm, /*keep_h=*/true)) throw ParseError{};

    // intra-monomer bonds (unit weights) in sorted (min,max) order,
    // then stochastic inter-monomer bonds with directed weights
    int n_intra = (int)pm.bonds.size();
    g.n_bonds = 2 * (n_intra + (int)pinfo.size());
    g.f_bonds.resize((size_t)g.n_bonds * (ATOM_FDIM + BOND_FDIM));
    g.b2a.resize(g.n_bonds);
    g.b2dst.resize(g.n_bonds);
    g.b2revb.resize(g.n_bonds);
    g.w_bonds.resize(g.n_bonds);
    std::vector<int> order_idx(pm.bonds.size());
    for (size_t i = 0; i < pm.bonds.size(); i++) order_idx[i] = (int)i;
    std::sort(order_idx.begin(), order_idx.end(), [&](int x, int y) {
      int x1 = std::min(pm.bonds[x].a1, pm.bonds[x].a2);
      int x2 = std::max(pm.bonds[x].a1, pm.bonds[x].a2);
      int y1 = std::min(pm.bonds[y].a1, pm.bonds[y].a2);
      int y2 = std::max(pm.bonds[y].a1, pm.bonds[y].a2);
      return x1 != y1 ? x1 < y1 : x2 < y2;
    });
    int bid = 0;
    float fb[BOND_FDIM];
    auto emit_pair = [&](int a1, int a2, const float* fbond, float w12,
                         float w21) {
      for (int dir = 0; dir < 2; dir++) {
        int src = dir == 0 ? a1 : a2;
        float* row = &g.f_bonds[(size_t)bid * (ATOM_FDIM + BOND_FDIM)];
        std::memcpy(row, &g.f_atoms[(size_t)src * ATOM_FDIM],
                    ATOM_FDIM * sizeof(float));
        std::memcpy(row + ATOM_FDIM, fbond, BOND_FDIM * sizeof(float));
        g.b2a[bid] = src;
        g.b2dst[bid] = dir == 0 ? a2 : a1;
        g.b2revb[bid] = dir == 0 ? bid + 1 : bid - 1;
        g.w_bonds[bid] = dir == 0 ? w12 : w21;
        bid++;
      }
    };
    for (int bi : order_idx) {
      int a1 = std::min(pm.bonds[bi].a1, pm.bonds[bi].a2);
      int a2 = std::max(pm.bonds[bi].a1, pm.bonds[bi].a2);
      bond_features(pm, bi, fb);
      emit_pair(a1, a2, fb, 1.f, 1.f);
    }
    for (const auto& r : pinfo) {
      // Python scans all atoms; the LAST atom carrying the tag wins.
      // attach holds exactly that (map overwrite), but mirror the miss
      // behaviour: unknown tag -> error (featurization.py:381-384).
      auto i1 = attach.find("*" + r.r1);
      auto i2 = attach.find("*" + r.r2);
      if (i1 == attach.end() || i1->second < 0 ||
          i2 == attach.end() || i2->second < 0)
        throw ParseError{};
      auto o1 = r_bond_types.find("*" + r.r1);
      auto o2 = r_bond_types.find("*" + r.r2);
      if (o1 == r_bond_types.end() || o2 == r_bond_types.end() ||
          o1->second != o2->second)
        throw ParseError{};
      synthetic_bond_features(pm, i1->second, i2->second, o1->second, fb);
      emit_pair(i1->second, i2->second, fb, (float)r.w12, (float)r.w21);
    }
    g.degree_of_polym = (float)dop;
    g.valid = true;
  } catch (...) {
    return PackedGraph{};
  }
  return g;
}

// ------------------------------------------------------ reaction featurizer
// Mirrors features/featurization.py MolGraph._build_reaction (reference
// featurization.py:644-740): atom-mapped "reac>agents>prod" SMILES, six
// modes (reac_prod/reac_diff/prod_diff × plain/balance).

constexpr int RXN_EXTRA_A = ATOM_FDIM - MAX_ATOMIC_NUM - 1;  // 32
constexpr int RXN_ATOM_FDIM = ATOM_FDIM + RXN_EXTRA_A;       // 165
constexpr int RXN_BOND_FDIM = 2 * BOND_FDIM;                 // 28

void atom_features_zeros_cpp(const Mol& m, int a, float* out) {
  for (int i = 0; i < ATOM_FDIM; i++) out[i] = 0.f;
  onek(m.atoms[a].z - 1, 100, out);
}

int bond_between(const Mol& m, int a1, int a2) {
  for (int bi : m.adj[a1])
    if (m.other(bi, a1) == a2) return bi;
  return -1;
}

// bond_features with the reference's None-bond convention ([1, 0...0])
void bond_features_opt(const Mol* m, int bi, float* out) {
  if (m == nullptr || bi < 0) {
    out[0] = 1.f;
    for (int i = 1; i < BOND_FDIM; i++) out[i] = 0.f;
    return;
  }
  bond_features(*m, bi, out);
}

PackedGraph featurize_reaction_one(const std::string& input, int mode,
                                   bool balance, bool keep_h,
                                   bool add_h = false) {
  // mode: 0 = reac_prod, 1 = reac_diff, 2 = prod_diff
  PackedGraph g;
  Mol reac, prod;
  try {
    auto first = input.find('>');
    auto last = input.rfind('>');
    if (first == std::string::npos) return g;
    auto parse_side = [&](const std::string& s) {
      SemOrder sem;
      Mol m = parse_smiles_raw(s, &sem);
      normalize_chirality(m, sem);
      if (!perceive(m, keep_h)) throw ParseError{};
      if (add_h && !materialize_hs(m)) throw ParseError{};
      return m;
    };
    reac = parse_side(input.substr(0, first));
    prod = parse_side(input.substr(last + 1));
  } catch (...) {
    return g;
  }
  int nr = (int)reac.atoms.size();
  // map_reac_to_prod (reference featurization.py:253-283)
  std::set<int> mapnos_reac;
  for (const Atom& a : reac.atoms)
    if (a.map > 0) mapnos_reac.insert(a.map);
  std::map<int, int> prod_map_to_id;
  std::vector<int> pio;
  for (int i = 0; i < (int)prod.atoms.size(); i++) {
    int mapno = prod.atoms[i].map;
    if (mapno > 0) {
      prod_map_to_id[mapno] = i;
      if (!mapnos_reac.count(mapno)) pio.push_back(i);
    } else {
      pio.push_back(i);
    }
  }
  std::vector<int> ri2pi(nr, -1);
  for (int a = 0; a < nr; a++) {
    int mapno = reac.atoms[a].map;
    if (mapno > 0) {
      auto it = prod_map_to_id.find(mapno);
      if (it != prod_map_to_id.end()) ri2pi[a] = it->second;
    }
  }

  int n_atoms = nr + (int)pio.size();
  std::vector<float> f_reac((size_t)n_atoms * ATOM_FDIM);
  std::vector<float> f_prod((size_t)n_atoms * ATOM_FDIM);
  for (int a = 0; a < nr; a++) {
    atom_features(reac, a, &f_reac[(size_t)a * ATOM_FDIM]);
    if (ri2pi[a] >= 0)
      atom_features(prod, ri2pi[a], &f_prod[(size_t)a * ATOM_FDIM]);
    else if (balance)
      atom_features(reac, a, &f_prod[(size_t)a * ATOM_FDIM]);
    else
      atom_features_zeros_cpp(reac, a, &f_prod[(size_t)a * ATOM_FDIM]);
  }
  for (size_t k = 0; k < pio.size(); k++) {
    size_t row = (nr + k) * ATOM_FDIM;
    atom_features(prod, pio[k], &f_prod[row]);
    if (balance)
      atom_features(prod, pio[k], &f_reac[row]);
    else
      atom_features_zeros_cpp(prod, pio[k], &f_reac[row]);
  }

  g.n_atoms = n_atoms;
  g.f_atoms.resize((size_t)n_atoms * RXN_ATOM_FDIM);
  for (int a = 0; a < n_atoms; a++) {
    const float* fr = &f_reac[(size_t)a * ATOM_FDIM];
    const float* fp = &f_prod[(size_t)a * ATOM_FDIM];
    float* out = &g.f_atoms[(size_t)a * RXN_ATOM_FDIM];
    // first half: reac (reac_prod/reac_diff) or prod (prod_diff)
    const float* base = (mode == 2) ? fp : fr;
    std::memcpy(out, base, ATOM_FDIM * sizeof(float));
    // second half (past the atomic-number one-hot): prod or diff
    for (int i = MAX_ATOMIC_NUM + 1; i < ATOM_FDIM; i++)
      out[ATOM_FDIM + i - (MAX_ATOMIC_NUM + 1)] =
          (mode == 0) ? fp[i] : fp[i] - fr[i];
  }

  // pairwise bond scan (reference featurization.py:689-740)
  std::vector<std::array<float, RXN_BOND_FDIM>> bfeats;
  std::vector<std::pair<int, int>> bpairs;
  float fr[BOND_FDIM], fp[BOND_FDIM];
  for (int a1 = 0; a1 < n_atoms; a1++) {
    for (int a2 = a1 + 1; a2 < n_atoms; a2++) {
      const Mol* mr = nullptr;
      const Mol* mp = nullptr;
      int br = -1, bp = -1;
      if (a1 >= nr && a2 >= nr) {
        bp = bond_between(prod, pio[a1 - nr], pio[a2 - nr]);
        mp = bp >= 0 ? &prod : nullptr;
        if (balance && bp >= 0) { br = bp; mr = &prod; }
      } else if (a1 < nr && a2 >= nr) {
        if (ri2pi[a1] >= 0) {
          bp = bond_between(prod, ri2pi[a1], pio[a2 - nr]);
          mp = bp >= 0 ? &prod : nullptr;
        }
      } else {
        br = bond_between(reac, a1, a2);
        mr = br >= 0 ? &reac : nullptr;
        if (ri2pi[a1] >= 0 && ri2pi[a2] >= 0) {
          bp = bond_between(prod, ri2pi[a1], ri2pi[a2]);
          mp = bp >= 0 ? &prod : nullptr;
        } else if (balance && ri2pi[a1] < 0 && ri2pi[a2] < 0 && br >= 0) {
          bp = br;
          mp = &reac;
        }
      }
      if (mr == nullptr && mp == nullptr) continue;
      bond_features_opt(mr, br, fr);
      bond_features_opt(mp, bp, fp);
      std::array<float, RXN_BOND_FDIM> fb;
      for (int i = 0; i < BOND_FDIM; i++) {
        fb[i] = (mode == 2) ? fp[i] : fr[i];
        fb[BOND_FDIM + i] = (mode == 0) ? fp[i] : fp[i] - fr[i];
      }
      bfeats.push_back(fb);
      bpairs.push_back({a1, a2});
    }
  }

  g.n_bonds = 2 * (int)bpairs.size();
  g.f_bonds.resize((size_t)g.n_bonds * (RXN_ATOM_FDIM + RXN_BOND_FDIM));
  g.b2a.resize(g.n_bonds);
  g.b2dst.resize(g.n_bonds);
  g.b2revb.resize(g.n_bonds);
  int bid = 0;
  for (size_t k = 0; k < bpairs.size(); k++) {
    for (int dir = 0; dir < 2; dir++) {
      int src = dir == 0 ? bpairs[k].first : bpairs[k].second;
      int dst = dir == 0 ? bpairs[k].second : bpairs[k].first;
      float* row = &g.f_bonds[(size_t)bid * (RXN_ATOM_FDIM + RXN_BOND_FDIM)];
      std::memcpy(row, &g.f_atoms[(size_t)src * RXN_ATOM_FDIM],
                  RXN_ATOM_FDIM * sizeof(float));
      std::memcpy(row + RXN_ATOM_FDIM, bfeats[k].data(),
                  RXN_BOND_FDIM * sizeof(float));
      g.b2a[bid] = src;
      g.b2dst[bid] = dst;
      g.b2revb[bid] = dir == 0 ? bid + 1 : bid - 1;
      bid++;
    }
  }
  g.valid = true;
  return g;
}

}  // namespace

// -------------------------------------------------------------------- C API

extern "C" {

// Featurize a batch of SMILES into caller-allocated padded arrays in the
// GraphBatch layout (index 0 of atoms/bonds reserved; see
// features/batching.py). Returns 0 on success, -1 if the padded envelope
// is too small; per-molecule validity in `valid_out`.
//
// smiles: array of n NUL-terminated strings
// arrays: f_atoms (pad_atoms*133), f_bonds (pad_bonds*147),
//         w_atoms (pad_atoms), w_bonds (pad_bonds),
//         b2a/b2dst/b2revb (pad_bonds, int32), a2mol (pad_atoms, int32)
// counts_out: [n_atoms_real, n_bonds_real]
int pcp_featurize_batch_impl(const char** smiles, int n,
                             int pad_atoms, int pad_bonds,
                             float* f_atoms, float* f_bonds,
                             float* w_atoms, float* w_bonds,
                             int* b2a, int* b2dst, int* b2revb, int* a2mol,
                             float* dop_out,
                             unsigned char* valid_out, int* counts_out,
                             int n_threads,
                             const std::function<PackedGraph(const char*)>& fn,
                             int atom_width, int bond_width,
                             int* b2parse_out = nullptr) {
  std::vector<PackedGraph> graphs(n);
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::atomic<int> next_idx{0};
  auto worker = [&]() {
    while (true) {
      int i = next_idx.fetch_add(1);
      if (i >= n) break;
      graphs[i] = fn(smiles[i]);
    }
  };
  for (int t = 0; t < n_threads - 1; t++) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();

  std::memset(f_atoms, 0, sizeof(float) * (size_t)pad_atoms * atom_width);
  std::memset(f_bonds, 0, sizeof(float) * (size_t)pad_bonds * bond_width);
  std::memset(w_atoms, 0, sizeof(float) * pad_atoms);
  std::memset(w_bonds, 0, sizeof(float) * pad_bonds);
  std::memset(b2a, 0, sizeof(int) * pad_bonds);
  std::memset(b2dst, 0, sizeof(int) * pad_bonds);
  std::memset(b2revb, 0, sizeof(int) * pad_bonds);
  std::memset(a2mol, 0, sizeof(int) * pad_atoms);

  if (b2parse_out)
    std::memset(b2parse_out, 0, sizeof(int) * pad_bonds);
  int ai = 1, bi = 1;
  int parse_off = 0;  // cumulative undirected bond count across valid mols
  for (int i = 0; i < n; i++) {
    const PackedGraph& g = graphs[i];
    valid_out[i] = g.valid ? 1 : 0;
    if (dop_out) dop_out[i] = g.valid ? g.degree_of_polym : 1.f;
    if (!g.valid) continue;
    if (ai + g.n_atoms > pad_atoms || bi + g.n_bonds > pad_bonds) return -1;
    std::memcpy(&f_atoms[(size_t)ai * atom_width], g.f_atoms.data(),
                g.f_atoms.size() * sizeof(float));
    std::memcpy(&f_bonds[(size_t)bi * bond_width],
                g.f_bonds.data(), g.f_bonds.size() * sizeof(float));
    for (int a = 0; a < g.n_atoms; a++) {
      w_atoms[ai + a] = g.w_atoms.empty() ? 1.f : g.w_atoms[a];
      a2mol[ai + a] = i;
    }
    for (int b = 0; b < g.n_bonds; b++) {
      w_bonds[bi + b] = g.w_bonds.empty() ? 1.f : g.w_bonds[b];
      b2a[bi + b] = g.b2a[b] + ai;
      b2dst[bi + b] = g.b2dst[b] + ai;
      b2revb[bi + b] = g.b2revb[b] + bi;
      // 1-based global parse id (0 = padding) so the caller can gather
      // per-bond extras from a zero-prepended concatenation
      if (b2parse_out && !g.b2parse.empty())
        b2parse_out[bi + b] = g.b2parse[b] + parse_off + 1;
    }
    ai += g.n_atoms;
    bi += g.n_bonds;
    parse_off += g.n_bonds / 2;
  }
  counts_out[0] = ai;
  counts_out[1] = bi;
  return 0;
}

int pcp_featurize_batch(const char** smiles, int n,
                        int pad_atoms, int pad_bonds,
                        float* f_atoms, float* f_bonds,
                        float* w_atoms, float* w_bonds,
                        int* b2a, int* b2dst, int* b2revb, int* a2mol,
                        unsigned char* valid_out, int* counts_out,
                        int n_threads) {
  return pcp_featurize_batch_impl(
      smiles, n, pad_atoms, pad_bonds, f_atoms, f_bonds, w_atoms, w_bonds,
      b2a, b2dst, b2revb, a2mol, nullptr, valid_out, counts_out, n_threads,
      [](const char* s) { return featurize_one(s); },
      ATOM_FDIM, ATOM_FDIM + BOND_FDIM);
}

// Standard molecules, full-featured: keep_h/add_h plus the per-directed-
// bond global parse-order index (1-based, 0 = padding) for aligning user
// per-bond extra-feature files (reference bond.GetIdx() convention).
int pcp_featurize_batch_full(const char** smiles, int n,
                             int pad_atoms, int pad_bonds,
                             float* f_atoms, float* f_bonds,
                             float* w_atoms, float* w_bonds,
                             int* b2a, int* b2dst, int* b2revb, int* a2mol,
                             unsigned char* valid_out, int* counts_out,
                             int n_threads, int keep_h, int add_h,
                             int* b2parse_out) {
  auto fn = [keep_h, add_h](const char* s) {
    return featurize_one(s, keep_h != 0, add_h != 0);
  };
  return pcp_featurize_batch_impl(
      smiles, n, pad_atoms, pad_bonds, f_atoms, f_bonds, w_atoms, w_bonds,
      b2a, b2dst, b2revb, a2mol, nullptr, valid_out, counts_out, n_threads,
      fn, ATOM_FDIM, ATOM_FDIM + BOND_FDIM, b2parse_out);
}

// Standard molecules with explicit-H retention (keep_h) and/or AddHs
// (add_h) — the reference's --explicit_h / --adding_h flags.
int pcp_featurize_batch_h(const char** smiles, int n,
                          int pad_atoms, int pad_bonds,
                          float* f_atoms, float* f_bonds,
                          float* w_atoms, float* w_bonds,
                          int* b2a, int* b2dst, int* b2revb, int* a2mol,
                          unsigned char* valid_out, int* counts_out,
                          int n_threads, int keep_h, int add_h) {
  auto fn = [keep_h, add_h](const char* s) {
    return featurize_one(s, keep_h != 0, add_h != 0);
  };
  return pcp_featurize_batch_impl(
      smiles, n, pad_atoms, pad_bonds, f_atoms, f_bonds, w_atoms, w_bonds,
      b2a, b2dst, b2revb, a2mol, nullptr, valid_out, counts_out, n_threads,
      fn, ATOM_FDIM, ATOM_FDIM + BOND_FDIM);
}

// Polymer-mode batch featurization: input strings are wD-MPNN copolymer
// ensembles "monA.monB|w1|w2|<1-2:w12:w21...~Xn"; additionally writes the
// per-molecule degree-of-polymerization factor 1+log10(Xn).
int pcp_featurize_polymer_batch(const char** smiles, int n,
                                int pad_atoms, int pad_bonds,
                                float* f_atoms, float* f_bonds,
                                float* w_atoms, float* w_bonds,
                                int* b2a, int* b2dst, int* b2revb, int* a2mol,
                                float* dop_out,
                                unsigned char* valid_out, int* counts_out,
                                int n_threads) {
  return pcp_featurize_batch_impl(
      smiles, n, pad_atoms, pad_bonds, f_atoms, f_bonds, w_atoms, w_bonds,
      b2a, b2dst, b2revb, a2mol, dop_out, valid_out, counts_out, n_threads,
      [](const char* s) { return featurize_polymer_one(s); },
      ATOM_FDIM, ATOM_FDIM + BOND_FDIM);
}

// Polymer mode with explicit-H retention / AddHs (per monomer fragment,
// like the reference's make_polymer_mol keep_h/add_h args, rdkit.py:21-51).
int pcp_featurize_polymer_batch_h(const char** smiles, int n,
                                  int pad_atoms, int pad_bonds,
                                  float* f_atoms, float* f_bonds,
                                  float* w_atoms, float* w_bonds,
                                  int* b2a, int* b2dst, int* b2revb,
                                  int* a2mol, float* dop_out,
                                  unsigned char* valid_out, int* counts_out,
                                  int n_threads, int keep_h, int add_h) {
  auto fn = [keep_h, add_h](const char* s) {
    return featurize_polymer_one(s, keep_h != 0, add_h != 0);
  };
  return pcp_featurize_batch_impl(
      smiles, n, pad_atoms, pad_bonds, f_atoms, f_bonds, w_atoms, w_bonds,
      b2a, b2dst, b2revb, a2mol, dop_out, valid_out, counts_out, n_threads,
      fn, ATOM_FDIM, ATOM_FDIM + BOND_FDIM);
}

// Reaction-mode batch featurization: atom-mapped "reac>agents>prod" SMILES.
// mode: 0 = reac_prod, 1 = reac_diff, 2 = prod_diff; balance applies the
// *_balance variants; keep_h preserves explicit [H] atoms as graph nodes
// (--explicit_h). Feature widths double: f_atoms rows are 165 floats,
// f_bonds rows 165+28 = 193.
int pcp_featurize_reaction_batch(const char** smiles, int n,
                                 int pad_atoms, int pad_bonds,
                                 float* f_atoms, float* f_bonds,
                                 float* w_atoms, float* w_bonds,
                                 int* b2a, int* b2dst, int* b2revb,
                                 int* a2mol,
                                 unsigned char* valid_out, int* counts_out,
                                 int n_threads, int mode, int balance,
                                 int keep_h) {
  auto fn = [mode, balance, keep_h](const char* s) {
    return featurize_reaction_one(s, mode, balance != 0, keep_h != 0);
  };
  return pcp_featurize_batch_impl(
      smiles, n, pad_atoms, pad_bonds, f_atoms, f_bonds, w_atoms, w_bonds,
      b2a, b2dst, b2revb, a2mol, nullptr, valid_out, counts_out, n_threads,
      fn, RXN_ATOM_FDIM, RXN_ATOM_FDIM + RXN_BOND_FDIM);
}

// Reaction mode with AddHs (--adding_h): implicit hydrogens materialized
// per side before the mapping/diff featurization.
int pcp_featurize_reaction_batch_h(const char** smiles, int n,
                                   int pad_atoms, int pad_bonds,
                                   float* f_atoms, float* f_bonds,
                                   float* w_atoms, float* w_bonds,
                                   int* b2a, int* b2dst, int* b2revb,
                                   int* a2mol,
                                   unsigned char* valid_out, int* counts_out,
                                   int n_threads, int mode, int balance,
                                   int keep_h, int add_h) {
  auto fn = [mode, balance, keep_h, add_h](const char* s) {
    return featurize_reaction_one(s, mode, balance != 0, keep_h != 0,
                                  add_h != 0);
  };
  return pcp_featurize_batch_impl(
      smiles, n, pad_atoms, pad_bonds, f_atoms, f_bonds, w_atoms, w_bonds,
      b2a, b2dst, b2revb, a2mol, nullptr, valid_out, counts_out, n_threads,
      fn, RXN_ATOM_FDIM, RXN_ATOM_FDIM + RXN_BOND_FDIM);
}

// Count atoms/bonds per molecule without packing (for envelope sizing).
int pcp_count_impl(const char** smiles, int n, int* atoms_out, int* bonds_out,
                   int n_threads,
                   const std::function<PackedGraph(const char*)>& fn) {
  std::vector<std::thread> pool;
  std::atomic<int> next_idx{0};
  auto worker = [&]() {
    while (true) {
      int i = next_idx.fetch_add(1);
      if (i >= n) break;
      PackedGraph g = fn(smiles[i]);
      atoms_out[i] = g.valid ? g.n_atoms : -1;
      bonds_out[i] = g.valid ? g.n_bonds : -1;
    }
  };
  if (n_threads < 1) n_threads = 1;
  for (int t = 0; t < n_threads - 1; t++) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  return 0;
}

int pcp_count(const char** smiles, int n, int* atoms_out, int* bonds_out,
              int n_threads) {
  return pcp_count_impl(smiles, n, atoms_out, bonds_out, n_threads,
                        [](const char* s) { return featurize_one(s); });
}

int pcp_count_h(const char** smiles, int n, int* atoms_out, int* bonds_out,
                int n_threads, int keep_h, int add_h) {
  auto fn = [keep_h, add_h](const char* s) {
    return featurize_one(s, keep_h != 0, add_h != 0);
  };
  return pcp_count_impl(smiles, n, atoms_out, bonds_out, n_threads, fn);
}

int pcp_count_polymer(const char** smiles, int n, int* atoms_out,
                      int* bonds_out, int n_threads) {
  return pcp_count_impl(
      smiles, n, atoms_out, bonds_out, n_threads,
      [](const char* s) { return featurize_polymer_one(s); });
}

int pcp_count_polymer_h(const char** smiles, int n, int* atoms_out,
                        int* bonds_out, int n_threads, int keep_h,
                        int add_h) {
  auto fn = [keep_h, add_h](const char* s) {
    return featurize_polymer_one(s, keep_h != 0, add_h != 0);
  };
  return pcp_count_impl(smiles, n, atoms_out, bonds_out, n_threads, fn);
}

int pcp_count_reaction(const char** smiles, int n, int* atoms_out,
                       int* bonds_out, int n_threads, int mode, int balance,
                       int keep_h) {
  auto fn = [mode, balance, keep_h](const char* s) {
    return featurize_reaction_one(s, mode, balance != 0, keep_h != 0);
  };
  return pcp_count_impl(smiles, n, atoms_out, bonds_out, n_threads, fn);
}

int pcp_count_reaction_h(const char** smiles, int n, int* atoms_out,
                         int* bonds_out, int n_threads, int mode,
                         int balance, int keep_h, int add_h) {
  auto fn = [mode, balance, keep_h, add_h](const char* s) {
    return featurize_reaction_one(s, mode, balance != 0, keep_h != 0,
                                  add_h != 0);
  };
  return pcp_count_impl(smiles, n, atoms_out, bonds_out, n_threads, fn);
}

}  // extern "C"

#include "pcp_descriptors.inc"
