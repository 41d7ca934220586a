// Native prefetching batch loader.
//
// Counterpart of the tf.data C++ pipeline the reference leans on
// (TextLineDataset -> shuffle -> padded_batch, reference utils.py:77-159):
// a background worker thread assembles fixed-shape padded int32 batches from
// the pre-tokenized corpus into a bounded ring of slots, overlapping host-side
// batch assembly with device steps. The Python twin is
// transformer_tpu_torch/data/pipeline.py:Seq2SeqDataset (in-memory, same padding
// semantics: pad id 0, truncate-to-length, all-pad fill rows for the final
// partial batch so every shard sees identical batch counts).
//
// Shuffling uses an explicit splitmix64-keyed Fisher-Yates so epoch order is
// reproducible across platforms/stdlib versions for a given (seed, epoch).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t &state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

struct Loader {
  // Corpus: flattened ids + offsets (offsets[i]..offsets[i+1] = example i).
  std::vector<int32_t> src_flat, tgt_flat;
  std::vector<int64_t> src_off, tgt_off;
  int64_t n_examples = 0;

  int32_t global_batch = 0, local_batch = 0, lo = 0;
  int32_t src_len = 0, tgt_len = 0, pad_id = 0;

  // Length bucketing (pipeline.py Seq2SeqDataset.length_buckets): ascending
  // widths; example i lands in the smallest bucket that fits
  // max(len(src_i), len(tgt_i)); batches form within buckets and are padded
  // to the bucket width only. Empty = single fixed width.
  std::vector<int32_t> bucket_widths;
  std::vector<int32_t> bucket_of;  // per-example bucket index

  // Slot ring: each slot holds one (src, tgt) local batch plus its padded
  // widths (== src_len/tgt_len unbucketed, == the bucket width bucketed).
  struct Slot {
    std::vector<int32_t> src, tgt;
    int32_t src_w = 0, tgt_w = 0;
    bool full = false;
  };
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_producer, cv_consumer;
  // Queue of filled slot ids in production order.
  std::vector<int32_t> ready;
  int64_t produced = 0, total_batches = 0;
  bool epoch_done = true, stop = false;
  std::atomic<bool> cancel{false};  // abandons the in-flight epoch
  std::thread worker;

  ~Loader() { shutdown(); }

  void shutdown() {
    {
      std::unique_lock<std::mutex> lk(mu);
      stop = true;
    }
    cv_producer.notify_all();
    cv_consumer.notify_all();
    if (worker.joinable()) worker.join();
  }

  void fill_row(int32_t *dst, const std::vector<int32_t> &flat,
                const std::vector<int64_t> &off, int64_t idx, int32_t len) {
    if (pad_id == 0)
      std::memset(dst, 0, sizeof(int32_t) * static_cast<size_t>(len));
    else
      std::fill(dst, dst + len, pad_id);
    if (idx < 0) return;  // all-pad fill row of a partial final batch
    int64_t n = off[idx + 1] - off[idx];
    if (n > len) n = len;  // truncate-to-length (pipeline.py _pad)
    std::memcpy(dst, flat.data() + off[idx], sizeof(int32_t) * static_cast<size_t>(n));
  }

  template <typename T>
  static void fisher_yates(std::vector<T> &v, uint64_t &s) {
    for (int64_t i = static_cast<int64_t>(v.size()) - 1; i > 0; --i) {
      int64_t j = static_cast<int64_t>(splitmix64(s) % static_cast<uint64_t>(i + 1));
      std::swap(v[static_cast<size_t>(i)], v[static_cast<size_t>(j)]);
    }
  }

  // One planned global batch: rows come from (*pool)[base + lo + row],
  // padded to (src_w, tgt_w); positions past the pool are all-pad fill.
  struct PlanBatch {
    const std::vector<int64_t> *pool;
    int64_t base;
    int32_t src_w, tgt_w;
  };

  void run_epoch(uint64_t seed, bool shuffle, bool drop_remainder) {
    uint64_t s = seed;
    std::vector<int64_t> order;                 // unbucketed pool
    std::vector<std::vector<int64_t>> members;  // per-bucket pools
    std::vector<PlanBatch> plan;

    auto plan_pool = [&](const std::vector<int64_t> &pool, int32_t sw, int32_t tw) {
      int64_t n = static_cast<int64_t>(pool.size());
      int64_t nb = n / global_batch;
      if (!drop_remainder && n % global_batch) ++nb;
      for (int64_t b = 0; b < nb; ++b)
        plan.push_back(PlanBatch{&pool, b * global_batch, sw, tw});
    };

    if (bucket_widths.empty()) {
      order.resize(static_cast<size_t>(n_examples));
      for (int64_t i = 0; i < n_examples; ++i) order[static_cast<size_t>(i)] = i;
      if (shuffle) fisher_yates(order, s);
      plan_pool(order, src_len, tgt_len);
    } else {
      // Batches form inside each bucket, then the batch PLAN is shuffled so
      // an epoch interleaves widths (pipeline.py _bucketed_batches; the
      // PRNG differs from the numpy path — splitmix64 here — but is equally
      // deterministic per (seed, epoch) and identical on every host).
      members.resize(bucket_widths.size());
      for (int64_t i = 0; i < n_examples; ++i)
        members[static_cast<size_t>(bucket_of[static_cast<size_t>(i)])]
            .push_back(i);
      for (size_t b = 0; b < members.size(); ++b) {
        if (shuffle) fisher_yates(members[b], s);
        plan_pool(members[b], bucket_widths[b], bucket_widths[b]);
      }
      if (shuffle) fisher_yates(plan, s);
    }

    int64_t nb = static_cast<int64_t>(plan.size());
    {
      std::unique_lock<std::mutex> lk(mu);
      total_batches = nb;
      produced = 0;
      epoch_done = (nb == 0);
      ready.clear();
      for (auto &sl : slots) sl.full = false;
    }
    cv_consumer.notify_all();

    for (int64_t b = 0; b < nb; ++b) {
      int32_t slot_id = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_producer.wait(lk, [&] {
          if (stop || cancel.load()) return true;
          for (size_t i = 0; i < slots.size(); ++i)
            if (!slots[i].full) return true;
          return false;
        });
        if (stop || cancel.load()) return;
        for (size_t i = 0; i < slots.size(); ++i)
          if (!slots[i].full) {
            slot_id = static_cast<int32_t>(i);
            break;
          }
      }
      Slot &slot = slots[static_cast<size_t>(slot_id)];
      const PlanBatch &pb = plan[static_cast<size_t>(b)];
      slot.src_w = pb.src_w;
      slot.tgt_w = pb.tgt_w;
      int64_t pool_n = static_cast<int64_t>(pb.pool->size());
      for (int32_t row = 0; row < local_batch; ++row) {
        int64_t gpos = pb.base + lo + row;
        int64_t idx = gpos < pool_n ? (*pb.pool)[static_cast<size_t>(gpos)] : -1;
        fill_row(slot.src.data() + static_cast<size_t>(row) * pb.src_w,
                 src_flat, src_off, idx, pb.src_w);
        fill_row(slot.tgt.data() + static_cast<size_t>(row) * pb.tgt_w,
                 tgt_flat, tgt_off, idx, pb.tgt_w);
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        slot.full = true;
        ready.push_back(slot_id);
        ++produced;
        if (produced == total_batches) epoch_done = true;
      }
      cv_consumer.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// buckets/n_buckets: ascending bucket widths (length bucketing); pass
// n_buckets == 0 for the single-fixed-width loader. The largest bucket must
// cover every example (the Python caller validates this before creating).
void *tpu_dl_create(const int32_t *src_flat, const int64_t *src_off,
                    const int32_t *tgt_flat, const int64_t *tgt_off,
                    int64_t n_examples, int32_t global_batch,
                    int32_t local_batch, int32_t lo, int32_t src_len,
                    int32_t tgt_len, int32_t pad_id, int32_t queue_depth,
                    const int32_t *buckets, int32_t n_buckets) {
  Loader *L = new Loader();
  L->src_flat.assign(src_flat, src_flat + src_off[n_examples]);
  L->src_off.assign(src_off, src_off + n_examples + 1);
  L->tgt_flat.assign(tgt_flat, tgt_flat + tgt_off[n_examples]);
  L->tgt_off.assign(tgt_off, tgt_off + n_examples + 1);
  L->n_examples = n_examples;
  L->global_batch = global_batch;
  L->local_batch = local_batch;
  L->lo = lo;
  L->src_len = src_len;
  L->tgt_len = tgt_len;
  L->pad_id = pad_id;
  if (n_buckets > 0) {
    L->bucket_widths.assign(buckets, buckets + n_buckets);
    L->bucket_of.resize(static_cast<size_t>(n_examples));
    for (int64_t i = 0; i < n_examples; ++i) {
      int64_t sn = src_off[i + 1] - src_off[i];
      int64_t tn = tgt_off[i + 1] - tgt_off[i];
      int64_t need = sn > tn ? sn : tn;
      int32_t b = n_buckets - 1;  // over-length truncates into the last bucket
      for (int32_t w = 0; w < n_buckets; ++w)
        if (need <= buckets[w]) {
          b = w;
          break;
        }
      L->bucket_of[static_cast<size_t>(i)] = b;
    }
  }
  L->slots.resize(static_cast<size_t>(queue_depth > 0 ? queue_depth : 2));
  // Bucket widths apply to BOTH sides of a batch and are bounded only by
  // max(src_len, tgt_len), so bucketed slots must size each side at that
  // max — sizing at the per-side len would overflow when a bucket is wider
  // than the narrower side.
  int32_t src_cap = src_len, tgt_cap = tgt_len;
  if (n_buckets > 0) {
    int32_t maxw = src_len > tgt_len ? src_len : tgt_len;
    src_cap = tgt_cap = maxw;
  }
  for (auto &s : L->slots) {
    s.src.resize(static_cast<size_t>(local_batch) * src_cap);
    s.tgt.resize(static_cast<size_t>(local_batch) * tgt_cap);
  }
  return L;
}

void tpu_dl_free(void *p) { delete static_cast<Loader *>(p); }

// Launch the producer for one epoch. Any previous epoch must be drained
// (or the loader freed) first.
void tpu_dl_start_epoch(void *p, uint64_t seed, int32_t shuffle,
                        int32_t drop_remainder) {
  Loader *L = static_cast<Loader *>(p);
  if (L->worker.joinable()) {
    // Abandon any undrained previous epoch so join cannot block on a full
    // ring (the consumer may have stopped iterating early).
    L->cancel.store(true);
    L->cv_producer.notify_all();
    L->worker.join();
    L->cancel.store(false);
  }
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->epoch_done = false;
    L->produced = 0;
    L->total_batches = -1;  // unknown until run_epoch computes it
    L->ready.clear();
    for (auto &s : L->slots) s.full = false;
  }
  L->worker = std::thread([L, seed, shuffle, drop_remainder] {
    L->run_epoch(seed, shuffle != 0, drop_remainder != 0);
  });
}

// Blocks until a batch is ready; copies it into the caller's buffers (sized
// for the loader's max widths) and reports the batch's actual padded widths
// in widths_out[0] (src) and widths_out[1] (tgt) — smaller than the maxima
// for bucketed batches. Returns 1 on success, 0 when the epoch is exhausted.
int32_t tpu_dl_next(void *p, int32_t *src_out, int32_t *tgt_out,
                    int32_t *widths_out) {
  Loader *L = static_cast<Loader *>(p);
  int32_t slot_id = -1;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_consumer.wait(lk, [&] {
      return L->stop || !L->ready.empty() ||
             (L->epoch_done && L->ready.empty());
    });
    if (L->stop || L->ready.empty()) return 0;
    slot_id = L->ready.front();
    L->ready.erase(L->ready.begin());
  }
  Loader::Slot &slot = L->slots[static_cast<size_t>(slot_id)];
  std::memcpy(src_out, slot.src.data(),
              static_cast<size_t>(L->local_batch) * slot.src_w * sizeof(int32_t));
  std::memcpy(tgt_out, slot.tgt.data(),
              static_cast<size_t>(L->local_batch) * slot.tgt_w * sizeof(int32_t));
  widths_out[0] = slot.src_w;
  widths_out[1] = slot.tgt_w;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    slot.full = false;
  }
  L->cv_producer.notify_one();
  return 1;
}

}  // extern "C"
