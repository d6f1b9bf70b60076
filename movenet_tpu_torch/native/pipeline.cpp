// movenet_tpu_torch native data pipeline: decode -> preprocess -> hand-off
// (host CPU, no device code); the port's own copy of
// movenet_tpu/native/pipeline.cpp.
//
// The Python loader (data/pipeline.py) runs per-clip work on a Python
// thread pool: an ffmpeg subprocess decode, then the C++ preprocess
// via per-call ctypes.  This module moves the WHOLE per-clip pipeline
// into C++ worker threads — each worker spawns the same ffmpeg
// commands (scaled-gray rawvideo + f32le PCM pipes), reads the pipes,
// and runs the preprocess routines from io_loader.cpp in-process — so
// a clip costs Python exactly one blocking mn_pipe_next() call, with
// no GIL round-trips, frame buffers, or numpy staging in between.
//
// Decode semantics mirror data/video.py::_decode_ffmpeg_cli exactly
// (same filter graph, same channel-mean ordering), so the produced
// codes/video are bit-identical to the Python path on the same file.
//
// Completion is IN SUBMISSION ORDER (mn_pipe_next blocks on the next
// sequential job) so epochs stay reproducible.
//
// Build: python -m movenet_tpu_torch.native.build  (one shared library
// together with io_loader.cpp).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// from io_loader.cpp (same shared library)
extern "C" int mn_preprocess_video(const uint8_t* video, long frames,
                                   long h, long w, long c, long num_out,
                                   long oh, long ow, float* out);
extern "C" int mn_preprocess_audio(const float* audio, long channels,
                                   long samples, long target,
                                   int quantization_channels,
                                   int normalize, int32_t* out);

namespace {

std::string shell_quote(const std::string& s) {
  std::string out = "'";
  for (char ch : s) {
    if (ch == '\'')
      out += "'\\''";
    else
      out += ch;
  }
  out += "'";
  return out;
}

// Read an entire pipe into `buf`; returns the subprocess exit code.
int read_pipe(const std::string& cmd, std::vector<uint8_t>& buf) {
  FILE* p = popen(cmd.c_str(), "r");
  if (!p) return -1;
  uint8_t chunk[1 << 16];
  size_t n;
  while ((n = fread(chunk, 1, sizeof(chunk), p)) > 0)
    buf.insert(buf.end(), chunk, chunk + n);
  return pclose(p);
}

struct Result {
  int status = 1;  // 0 ok, 1 failed/skip
  std::vector<int32_t> codes;
  std::vector<float> video;
};

struct Pipe {
  long num_frames, oh, ow, audio_target;
  int quant, normalize, use_video;
  int n_workers;

  std::mutex mu;
  std::condition_variable cv_jobs, cv_done;
  std::deque<std::pair<long, std::string>> jobs;
  std::map<long, Result> done;
  long next_submit = 0;
  long next_emit = 0;
  bool stopping = false;
  std::vector<std::thread> workers;

  void run_job(long id, const std::string& path) {
    Result r;
    r.status = process(path, r);
    std::lock_guard<std::mutex> lock(mu);
    done.emplace(id, std::move(r));
    cv_done.notify_all();
  }

  int process(const std::string& path, Result& r) {
    const std::string q = shell_quote(path);

    // ---- audio: channel count (ffprobe), then interleaved f32 PCM
    std::vector<uint8_t> chbuf;
    if (read_pipe("ffprobe -v error -select_streams a:0 -show_entries "
                  "stream=channels -of csv=p=0 " + q + " 2>/dev/null",
                  chbuf) != 0)
      return 1;
    long channels = atol(std::string(chbuf.begin(), chbuf.end()).c_str());
    if (channels <= 0) return 1;  // no audio stream: skip (loader rule)

    std::vector<uint8_t> pcm_raw;
    if (read_pipe("ffmpeg -v error -i " + q +
                  " -f f32le -acodec pcm_f32le - 2>/dev/null",
                  pcm_raw) != 0)
      return 1;
    long total = (long)(pcm_raw.size() / sizeof(float));
    long samples = total / channels;
    if (samples <= 0) return 1;
    const float* inter = reinterpret_cast<const float*>(pcm_raw.data());
    // interleaved -> channel-major, matching the Python
    // pcm.reshape(-1, ch).T staging before mn_preprocess_audio
    std::vector<float> chan_major((size_t)channels * samples);
    for (long i = 0; i < samples; ++i)
      for (long ch = 0; ch < channels; ++ch)
        chan_major[(size_t)ch * samples + i] = inter[i * channels + ch];
    r.codes.resize(audio_target);
    if (mn_preprocess_audio(chan_major.data(), channels, samples,
                            audio_target, quant, normalize,
                            r.codes.data()) != 0)
      return 1;

    // ---- video: scaled grayscale frames streamed from ffmpeg
    if (use_video) {
      std::vector<uint8_t> frames;
      char vf[128];
      snprintf(vf, sizeof(vf),
               " -vf scale=%ld:%ld:flags=bilinear,format=gray "
               "-f rawvideo -pix_fmt gray - 2>/dev/null",
               ow, oh);
      if (read_pipe("ffmpeg -v error -i " + q + vf, frames) != 0)
        return 1;
      long fbytes = oh * ow;
      long nframes = (long)(frames.size() / fbytes);
      if (nframes <= 0) return 1;
      r.video.resize((size_t)num_frames * oh * ow);
      if (mn_preprocess_video(frames.data(), nframes, oh, ow, 1,
                              num_frames, oh, ow, r.video.data()) != 0)
        return 1;
    }
    return 0;
  }

  void worker_loop() {
    for (;;) {
      std::pair<long, std::string> job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_jobs.wait(lock, [&] { return stopping || !jobs.empty(); });
        if (stopping && jobs.empty()) return;
        job = std::move(jobs.front());
        jobs.pop_front();
      }
      run_job(job.first, job.second);
    }
  }
};

}  // namespace

extern "C" {

void* mn_pipe_create(int n_workers, long num_frames, long oh, long ow,
                     long audio_target, int quant, int normalize,
                     int use_video) {
  auto* p = new Pipe();
  p->num_frames = num_frames;
  p->oh = oh;
  p->ow = ow;
  p->audio_target = audio_target;
  p->quant = quant;
  p->normalize = normalize;
  p->use_video = use_video;
  p->n_workers = n_workers < 1 ? 1 : n_workers;
  for (int i = 0; i < p->n_workers; ++i)
    p->workers.emplace_back([p] { p->worker_loop(); });
  return p;
}

long mn_pipe_submit(void* h, const char* path) {
  auto* p = static_cast<Pipe*>(h);
  std::lock_guard<std::mutex> lock(p->mu);
  long id = p->next_submit++;
  p->jobs.emplace_back(id, std::string(path));
  p->cv_jobs.notify_one();
  return id;
}

// Blocks until the next job IN SUBMISSION ORDER completes.  Returns
// 0 on success (outputs filled), 1 when the clip failed to decode
// (caller substitutes the next clip), -1 when no jobs are pending.
int mn_pipe_next(void* h, int32_t* codes_out, float* video_out) {
  auto* p = static_cast<Pipe*>(h);
  std::unique_lock<std::mutex> lock(p->mu);
  if (p->next_emit >= p->next_submit) return -1;
  long want = p->next_emit++;
  p->cv_done.wait(lock, [&] { return p->done.count(want) > 0; });
  Result r = std::move(p->done[want]);
  p->done.erase(want);
  lock.unlock();
  if (r.status != 0) return 1;
  std::memcpy(codes_out, r.codes.data(),
              sizeof(int32_t) * r.codes.size());
  if (p->use_video && video_out)
    std::memcpy(video_out, r.video.data(),
                sizeof(float) * r.video.size());
  return 0;
}

void mn_pipe_destroy(void* h) {
  auto* p = static_cast<Pipe*>(h);
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->stopping = true;
    p->cv_jobs.notify_all();
  }
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
