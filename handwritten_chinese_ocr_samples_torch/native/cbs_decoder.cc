// Native context beam search (CBS) + ARPA n-gram LM — C ABI for ctypes.
//
// Host-side counterpart of decode/beam_host.py (itself transcription-
// equivalent to the reference decoder, ctc_codec.py:124-307): prefix beam
// search over CTC posteriors with Katz-backoff n-gram scoring
// (kenlm.Model.score semantics, log10, bos=<s>, eos optional — matching
// lm/arpa.py). The Python host decoder is the correctness oracle
// (tests/test_torch_host_beam.py); this implementation exists because the
// serving path (the reference's OpenVINO deployment mode) runs the beam
// search per line on the host, where the Python loop is the bottleneck.
//
// Everything works in integer id spaces: codec class ids (blank 0, chars
// 1..N, unknown N+1) for the search, ARPA word ids for the LM. The caller
// provides codec->word mapping built from the vocabulary (OOV chars map to
// <unk>, as lm/arpa.py's _known()).
//
// Built with the host C++ compiler at first use (ops/_build.load_host).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

double log_add(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = std::max(a, b);
  return m + std::log1p(std::exp(std::min(a, b) - m));
}

// n-gram key: raw little-endian int32 concatenation.
std::string PackKey(const int32_t* ids, int n) {
  return std::string(reinterpret_cast<const char*>(ids),
                     static_cast<size_t>(n) * sizeof(int32_t));
}

// --------------------------------------------------------------- NgramLM
// Backend-agnostic n-gram model: text ARPA (hash maps built at load) or
// the first-party HBLM binary (zero-copy mmap; see lm/hblm.py for the
// format spec — both loaders score with identical Katz-backoff math).
class NgramLM {
 public:
  virtual ~NgramLM() = default;
  virtual int order() const = 0;
  virtual int unk_id() const = 0;
  virtual int bos_id() const = 0;
  virtual int eos_id() const = 0;
  // id of a word with a unigram entry; -1 otherwise (callers map to <unk>)
  virtual int KnownWordId(const std::string& w) const = 0;
  // log10 p(word | context), context capped to order-1, ids pre-mapped
  virtual double LogProb(const int32_t* ctx, int n, int32_t word) const = 0;

  // kenlm.Model.score on a word-id sequence (bos always on, as the
  // decoder uses it; eos optional).
  double Score(const int32_t* words, int n, bool eos) const {
    std::vector<int32_t> ctx;
    ctx.push_back(bos_id());
    double total = 0.0;
    auto step = [&](int32_t w) {
      int take = std::min<int>(order() - 1, static_cast<int>(ctx.size()));
      total += LogProb(ctx.data() + ctx.size() - take, take, w);
      ctx.push_back(w);
    };
    for (int i = 0; i < n; ++i) step(words[i]);
    if (eos) step(eos_id());
    return total;
  }
};

// ---------------------------------------------------------------- ArpaLM
class ArpaLM : public NgramLM {
 public:
  bool Load(const std::string& path) {
    std::ifstream f(path);
    if (!f.is_open()) return false;
    std::string line;
    int section = 0;
    while (std::getline(f, line)) {
      // strip trailing \r and surrounding whitespace
      while (!line.empty() && (line.back() == '\r' || line.back() == '\n' ||
                               line.back() == ' ' || line.back() == '\t'))
        line.pop_back();
      size_t start = line.find_first_not_of(" \t");
      if (start == std::string::npos) continue;
      if (start) line = line.substr(start);
      if (line == "\\end\\") break;
      if (line.size() > 7 && line.front() == '\\' &&
          line.compare(line.size() - 7, 7, "-grams:") == 0) {
        section = std::atoi(line.c_str() + 1);
        order_ = std::max(order_, section);
        continue;
      }
      if (section == 0) continue;
      std::istringstream ss(line);
      std::vector<std::string> parts;
      std::string tok;
      while (ss >> tok) parts.push_back(tok);
      if (static_cast<int>(parts.size()) < section + 1) continue;
      double logp = std::atof(parts[0].c_str());
      std::vector<int32_t> ids(section);
      for (int i = 0; i < section; ++i) ids[i] = Intern(parts[1 + i]);
      std::string key = PackKey(ids.data(), section);
      probs_[key] = logp;
      if (static_cast<int>(parts.size()) > section + 1)
        backoffs_[key] = std::atof(parts[1 + section].c_str());
    }
    if (order_ == 0) return false;
    unk_id_ = WordId("<unk>");
    bos_id_ = WordId("<s>");
    eos_id_ = WordId("</s>");
    return unk_id_ >= 0;
  }

  int order() const override { return order_; }
  int unk_id() const override { return unk_id_; }
  int bos_id() const override { return bos_id_; }
  int eos_id() const override { return eos_id_; }

  // id of a word that HAS a unigram entry; -1 otherwise (callers map to
  // <unk>, mirroring lm/arpa.py::_known)
  int KnownWordId(const std::string& w) const override {
    auto it = vocab_.find(w);
    if (it == vocab_.end()) return -1;
    int32_t id = it->second;
    return probs_.count(PackKey(&id, 1)) ? id : -1;
  }

  // log10 p(word | context) with Katz backoff; context already capped to
  // order-1 and vocabulary-mapped (lm/arpa.py::logprob).
  double LogProb(const int32_t* ctx, int n, int32_t word) const override {
    double backoff_acc = 0.0;
    std::vector<int32_t> ng;
    while (true) {
      ng.assign(ctx, ctx + n);
      ng.push_back(word);
      auto it = probs_.find(PackKey(ng.data(), n + 1));
      if (it != probs_.end()) return it->second + backoff_acc;
      if (n == 0) {
        int32_t u = unk_id_;
        auto uit = probs_.find(PackKey(&u, 1));
        return (uit != probs_.end() ? uit->second : 0.0) + backoff_acc;
      }
      auto bit = backoffs_.find(PackKey(ctx, n));
      backoff_acc += (bit != backoffs_.end() ? bit->second : 0.0);
      ctx += 1;
      n -= 1;
    }
  }

 private:
  int32_t Intern(const std::string& w) {
    auto it = vocab_.find(w);
    if (it != vocab_.end()) return it->second;
    int32_t id = static_cast<int32_t>(vocab_.size());
    vocab_.emplace(w, id);
    return id;
  }
  int WordId(const std::string& w) const {
    auto it = vocab_.find(w);
    return it == vocab_.end() ? -1 : it->second;
  }

  std::unordered_map<std::string, int32_t> vocab_;
  std::unordered_map<std::string, double> probs_;
  std::unordered_map<std::string, double> backoffs_;
  int order_ = 0;
  int unk_id_ = -1, bos_id_ = -1, eos_id_ = -1;
};

// ---------------------------------------------------------------- HblmLM
// Zero-copy mmap loader for the HBLM binary format (layout + hash spec in
// lm/hblm.py; equality with the Python loader locked by tests/test_torch_ngram.py).
class HblmLM : public NgramLM {
 public:
  static constexpr char kMagic[8] = {'H', 'B', 'L', 'M', 1, 0, 0, 0};
  static constexpr uint64_t kEmpty = ~0ULL;

  ~HblmLM() override {
    if (base_ != nullptr && base_ != MAP_FAILED) munmap(base_, size_);
  }

  bool Load(const std::string& path) {
    int fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 24) {
      ::close(fd);
      return false;
    }
    size_ = static_cast<size_t>(st.st_size);
    base_ = mmap(nullptr, size_, PROT_READ, MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (base_ == MAP_FAILED) return false;
    const char* p = static_cast<const char*>(base_);
    if (std::memcmp(p, kMagic, 8) != 0) return false;
    uint32_t n_vocab;
    std::memcpy(&order_, p + 8, 4);
    std::memcpy(&n_vocab, p + 12, 4);
    uint64_t blob_len;
    std::memcpy(&blob_len, p + 16, 8);
    size_t off = 24 + 8ULL * order_;  // skip counts[order]
    std::vector<uint64_t> slots(order_ > 1 ? order_ - 1 : 0);
    if (order_ > 1) {
      std::memcpy(slots.data(), p + off, 8ULL * (order_ - 1));
      off += 8ULL * (order_ - 1);
    }
    off += Pad8(off);
    // vocab blob: '\n'-joined utf-8 words, id = position
    const char* blob = p + off;
    size_t start = 0;
    for (size_t i = 0; i <= blob_len; ++i) {
      if (i == blob_len || blob[i] == '\n') {
        vocab_.emplace(std::string(blob + start, i - start),
                       static_cast<int32_t>(n_words_++));
        start = i + 1;
      }
    }
    off += blob_len + Pad8(blob_len);
    if (static_cast<uint32_t>(n_words_) != n_vocab) return false;
    uni_ = reinterpret_cast<const UniEntry*>(p + off);
    size_t uni_bytes = 8ULL * n_vocab;
    off += uni_bytes + Pad8(uni_bytes);
    for (uint64_t s : slots) {
      tables_.push_back(reinterpret_cast<const Entry*>(p + off));
      table_masks_.push_back(s - 1);  // power-of-two tables
      off += s * sizeof(Entry);
    }
    if (off > size_) return false;
    unk_id_ = WordId("<unk>");
    bos_id_ = WordId("<s>");
    eos_id_ = WordId("</s>");
    return unk_id_ >= 0;
  }

  int order() const override { return order_; }
  int unk_id() const override { return unk_id_; }
  int bos_id() const override { return bos_id_; }
  int eos_id() const override { return eos_id_; }

  int KnownWordId(const std::string& w) const override {
    return WordId(w);  // HBLM vocab IS the unigram set
  }

  double LogProb(const int32_t* ctx, int n, int32_t word) const override {
    double acc = 0.0;
    while (true) {
      const Hit h = Find(ctx, n, word);
      if (h.found) return h.prob + acc;
      if (n == 0) return uni_[unk_id_].prob + acc;
      const Hit b = FindContext(ctx, n);
      if (b.found) acc += b.backoff;
      ctx += 1;
      n -= 1;
    }
  }

 private:
  struct UniEntry {
    float prob;
    float backoff;
  };
  struct Entry {
    uint64_t key;
    float prob;
    float backoff;
  };
  struct Hit {
    bool found;
    double prob;
    double backoff;
  };

  static size_t Pad8(size_t n) { return (8 - n % 8) % 8; }

  // twin of lm/hblm.py::ngram_hash
  static uint64_t Hash(const int32_t* ids, int n) {
    uint64_t h = 0xCBF29CE484222325ULL;
    for (int i = 0; i < n; ++i) {
      h ^= static_cast<uint64_t>(static_cast<uint32_t>(ids[i])) +
           0x9E3779B9ULL;
      h *= 0x100000001B3ULL;
    }
    h ^= h >> 30;
    h *= 0xBF58476D1CE4E5B9ULL;
    h ^= h >> 27;
    h *= 0x94D049BB133111EBULL;
    h ^= h >> 31;
    return h == kEmpty ? 0 : h;
  }

  Hit Probe(int n, uint64_t h) const {
    const Entry* tab = tables_[n - 2];
    uint64_t mask = table_masks_[n - 2];
    uint64_t s = h & mask;
    // bounded probe: a corrupt/truncated file misses instead of hanging
    for (uint64_t i = 0; i <= mask; ++i) {
      const Entry& e = tab[s];
      if (e.key == h) return {true, e.prob, e.backoff};
      if (e.key == kEmpty) break;
      s = (s + 1) & mask;
    }
    return {false, 0.0, 0.0};
  }

  Hit Find(const int32_t* ctx, int n, int32_t word) const {
    if (n == 0) {
      const UniEntry& u = uni_[word];
      return {true, u.prob, u.backoff};
    }
    std::vector<int32_t> ids(ctx, ctx + n);
    ids.push_back(word);
    return Probe(n + 1, Hash(ids.data(), n + 1));
  }

  Hit FindContext(const int32_t* ctx, int n) const {
    if (n == 1) {
      const UniEntry& u = uni_[ctx[0]];
      return {true, u.prob, u.backoff};
    }
    return Probe(n, Hash(ctx, n));
  }

  int WordId(const std::string& w) const {
    auto it = vocab_.find(w);
    return it == vocab_.end() ? -1 : it->second;
  }

  void* base_ = nullptr;
  size_t size_ = 0;
  const UniEntry* uni_ = nullptr;
  std::vector<const Entry*> tables_;
  std::vector<uint64_t> table_masks_;
  std::unordered_map<std::string, int32_t> vocab_;
  int n_words_ = 0;
  int order_ = 0;
  int unk_id_ = -1, bos_id_ = -1, eos_id_ = -1;
};

constexpr char HblmLM::kMagic[8];

// ---------------------------------------------------------------- decoder
struct Beam {
  std::vector<int32_t> prefix;  // codec ids
  double pb = 0.0;
  double pnb = kNegInf;
  double pt = 0.0;
  double lm = 0.0;              // cumulative log10 P(prefix) (incremental)
  double prob() const { return log_add(pb, pnb); }
  double total() const { return prob() + pt; }
};

struct Decoder {
  const NgramLM* lm = nullptr;            // may be null (no LM scoring)
  std::vector<int32_t> codec2word;       // codec id -> ARPA word id
  int unknown_id = 0;
  int beam_size = 10;
  int search_depth = 10;
  double lm_panelty = 2.0;
  double len_bonus = 5.8;
  bool use_lm_score = true;
  bool skip_search = false;
  double prune = std::log(0.001);
  int suffix_len = 4;

  // scratch
  std::vector<double> logp_row;

  // context = last (order-1) ids of <s> + prefix, vocabulary-mapped
  void Context(const Beam& b, std::vector<int32_t>* ctx) const {
    ctx->clear();
    int need = lm->order() - 1;
    int take = std::min<int>(need, static_cast<int>(b.prefix.size()));
    if (take < need && static_cast<int>(b.prefix.size()) == take)
      ctx->push_back(lm->bos_id());
    for (int i = static_cast<int>(b.prefix.size()) - take;
         i < static_cast<int>(b.prefix.size()); ++i)
      ctx->push_back(codec2word[b.prefix[i]]);
  }

  double SuffixScore(const Beam& b, const std::vector<int32_t>& suffix_w)
      const {
    if (!lm) return 0.0;
    std::vector<int32_t> ctx;
    Context(b, &ctx);
    double total = 0.0;
    for (int32_t w : suffix_w) {
      int take = std::min<int>(lm->order() - 1,
                               static_cast<int>(ctx.size()));
      total += lm->LogProb(ctx.data() + ctx.size() - take, take, w);
      ctx.push_back(w);
    }
    return total;
  }

  double ExtendLm(const Beam& parent, int32_t codec_id) const {
    if (!lm) return 0.0;
    std::vector<int32_t> ctx;
    Context(parent, &ctx);
    return parent.lm + lm->LogProb(
        ctx.data(), static_cast<int>(ctx.size()), codec2word[codec_id]);
  }

  void SearchStep(std::vector<Beam>* beams,
                  const std::vector<int>& cands,
                  const float* logp, const std::vector<int32_t>& suffix_w) {
    std::vector<Beam> gen;
    std::unordered_map<std::string, size_t> index;
    auto bucket = [&](const std::vector<int32_t>& prefix) -> Beam* {
      std::string key =
          PackKey(prefix.data(), static_cast<int>(prefix.size()));
      auto it = index.find(key);
      if (it != index.end()) return &gen[it->second];
      gen.emplace_back();
      Beam* nb = &gen.back();
      nb->prefix = prefix;
      nb->pb = kNegInf;
      nb->pnb = kNegInf;
      nb->lm = std::numeric_limits<double>::quiet_NaN();  // fill on touch
      index.emplace(std::move(key), gen.size() - 1);
      return nb;
    };

    std::vector<int32_t> scratch;
    for (const Beam& beam : *beams) {
      for (int idx : cands) {
        if (idx >= unknown_id) continue;
        double p = logp[idx];
        if (idx == 0) {
          Beam* g = bucket(beam.prefix);
          if (std::isnan(g->lm)) g->lm = beam.lm;
          g->pb = log_add(g->pb, beam.prob() + p);
          continue;
        }
        int32_t tail = beam.prefix.empty() ? -1 : beam.prefix.back();
        scratch = beam.prefix;
        scratch.push_back(idx);
        Beam* gnew = bucket(scratch);
        if (std::isnan(gnew->lm)) gnew->lm = ExtendLm(beam, idx);
        if (idx != tail) {
          gnew->pnb = log_add(gnew->pnb, beam.prob() + p);
        } else {
          gnew->pnb = log_add(gnew->pnb, beam.pb + p);
          Beam* gold = bucket(beam.prefix);
          if (std::isnan(gold->lm)) gold->lm = beam.lm;
          gold->pnb = log_add(gold->pnb, beam.pnb + p);
        }
      }
    }

    for (Beam& b : gen) {
      if (use_lm_score && lm) {
        b.pt = (b.lm + SuffixScore(b, suffix_w)) * lm_panelty +
               static_cast<double>(b.prefix.size()) * len_bonus;
      } else {
        b.pt = static_cast<double>(b.prefix.size()) * len_bonus;
      }
    }
    std::stable_sort(gen.begin(), gen.end(),
                     [](const Beam& a, const Beam& b) {
                       return a.total() > b.total();
                     });
    if (static_cast<int>(gen.size()) > beam_size) gen.resize(beam_size);
    beams->swap(gen);
  }

  int Decode(const float* preds, int T, int D, bool already_log,
             int32_t* out, int out_cap) {
    std::vector<float> logbuf;
    const float* lp = preds;
    if (!already_log) {
      logbuf.resize(static_cast<size_t>(T) * D);
      for (int t = 0; t < T; ++t) {
        const float* row = preds + static_cast<size_t>(t) * D;
        float m = row[0];
        for (int d = 1; d < D; ++d) m = std::max(m, row[d]);
        double z = 0.0;
        for (int d = 0; d < D; ++d) z += std::exp(double(row[d]) - m);
        float lz = m + static_cast<float>(std::log(z));
        float* dst = logbuf.data() + static_cast<size_t>(t) * D;
        for (int d = 0; d < D; ++d) dst[d] = row[d] - lz;
      }
      lp = logbuf.data();
    }

    // greedy top line: collapsed argmax (char, t)
    std::vector<int> argmax(T);
    for (int t = 0; t < T; ++t) {
      const float* row = lp + static_cast<size_t>(t) * D;
      int best = 0;
      for (int d = 1; d < D; ++d)
        if (row[d] > row[best]) best = d;
      argmax[t] = best;
    }
    std::vector<std::pair<int32_t, int>> top_line;  // (codec id, t)
    for (int t = 0; t < T; ++t) {
      int i = argmax[t];
      if (i != 0 && i != unknown_id && !(t > 0 && argmax[t - 1] == i))
        top_line.emplace_back(i, t);
    }
    int end = top_line.empty()
                  ? 0
                  : std::min(top_line.back().second + suffix_len, T);

    auto suffix_after = [&](int t, std::vector<int32_t>* w) {
      w->clear();
      for (const auto& ct : top_line) {
        if (ct.second > t) {
          w->push_back(lm ? codec2word[ct.first] : ct.first);
          if (static_cast<int>(w->size()) >= suffix_len) break;
        }
      }
    };

    std::vector<Beam> beams(1);
    std::vector<int> cands;
    std::vector<int32_t> suffix_w;
    for (int t = 0; t < end; ++t) {
      const float* row = lp + static_cast<size_t>(t) * D;
      if (skip_search) {
        // survivors above the prune threshold (`ctc_codec.py:128,144`)
        cands.clear();
        for (int d = 0; d < D; ++d)
          if (row[d] > prune) cands.push_back(d);
        if (cands.size() == 1) {
          int pidx = cands[0];
          if (pidx >= unknown_id) continue;
          double p = row[pidx];
          for (Beam& b : beams) {
            int32_t tail = b.prefix.empty() ? -1 : b.prefix.back();
            if (pidx == 0) {
              b.pb = b.prob() + row[0];
            } else if (pidx != tail) {
              b.lm = ExtendLm(b, pidx);
              b.prefix.push_back(pidx);
              b.pnb = b.prob() + p;
              b.pb = kNegInf;
            } else if (b.pb != kNegInf) {
              b.lm = ExtendLm(b, pidx);
              b.prefix.push_back(pidx);
              b.pnb = b.pb + p;
              b.pb = kNegInf;
            } else {
              double prob = b.prob();
              b.pnb = b.pnb + p;
              b.pb = prob + row[0];
            }
          }
          continue;
        }
        suffix_after(t, &suffix_w);
        SearchStep(&beams, cands, row, suffix_w);
      } else {
        // visual candidates: top search_depth classes by posterior
        cands.resize(D);
        for (int d = 0; d < D; ++d) cands[d] = d;
        int k = std::min(search_depth, D);
        std::partial_sort(cands.begin(), cands.begin() + k, cands.end(),
                          [&](int a, int b) {
                            if (row[a] != row[b]) return row[a] > row[b];
                            return a < b;
                          });
        cands.resize(k);
        suffix_after(t, &suffix_w);
        SearchStep(&beams, cands, row, suffix_w);
      }
    }

    if (beams.empty()) return 0;
    const std::vector<int32_t>& best = beams[0].prefix;
    int n = std::min<int>(static_cast<int>(best.size()), out_cap);
    std::memcpy(out, best.data(), static_cast<size_t>(n) * sizeof(int32_t));
    return n;
  }
};

}  // namespace

extern "C" {

void* cbs_arpa_load(const char* path) {
  // one entry point for both n-gram formats: sniff the HBLM magic, fall
  // back to text ARPA (the kenlm.Model(path) role, ctc_codec.py:120-122)
  char head[8] = {0};
  {
    std::ifstream probe(path, std::ios::binary);
    if (!probe.is_open()) return nullptr;
    probe.read(head, 8);
  }
  if (std::memcmp(head, HblmLM::kMagic, 8) == 0) {
    auto lm = std::make_unique<HblmLM>();
    if (!lm->Load(path)) return nullptr;
    return lm.release();
  }
  auto lm = std::make_unique<ArpaLM>();
  if (!lm->Load(path)) return nullptr;
  return lm.release();
}

void cbs_arpa_free(void* lm) { delete static_cast<NgramLM*>(lm); }

int cbs_arpa_order(void* lm) { return static_cast<NgramLM*>(lm)->order(); }

int cbs_arpa_unk_id(void* lm) { return static_cast<NgramLM*>(lm)->unk_id(); }

int cbs_arpa_word_id(void* lm, const char* utf8) {
  return static_cast<NgramLM*>(lm)->KnownWordId(utf8);
}

double cbs_arpa_score_ids(void* lm, const int32_t* words, int n, int eos) {
  return static_cast<NgramLM*>(lm)->Score(words, n, eos != 0);
}

void* cbs_create(void* lm, const int32_t* codec2word, int num_classes,
                 int unknown_id, int beam_size, int search_depth,
                 double lm_panelty, double len_bonus, int use_lm_score,
                 int skip_search, double prune_log_prob, int suffix_len) {
  auto d = std::make_unique<Decoder>();
  d->lm = static_cast<const NgramLM*>(lm);
  if (codec2word && num_classes > 0)
    d->codec2word.assign(codec2word, codec2word + num_classes);
  d->unknown_id = unknown_id;
  d->beam_size = beam_size;
  d->search_depth = search_depth;
  d->lm_panelty = lm_panelty;
  d->len_bonus = len_bonus;
  d->use_lm_score = use_lm_score != 0;
  d->skip_search = skip_search != 0;
  d->prune = prune_log_prob;
  d->suffix_len = suffix_len;
  return d.release();
}

void cbs_free(void* dec) { delete static_cast<Decoder*>(dec); }

int cbs_decode(void* dec, const float* preds, int T, int D, int already_log,
               int32_t* out, int out_cap) {
  return static_cast<Decoder*>(dec)->Decode(preds, T, D, already_log != 0,
                                            out, out_cap);
}

}  // extern "C"
