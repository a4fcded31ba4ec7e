// Real-audio capture/playback shim feeding the SPSC sample rings.
//
// Reference equivalent: the JACK real-time process callback + AppShared
// buffers (src/audio/recorder.rs:35-153, src/device/jack.rs:17-64).
// Batch-native redesign: the cut point between real-time audio and the
// batched decode pipeline is the lock-free ring (tm_runtime.cc); this
// file adds the hardware-facing side:
//
// * ALSA backend, loaded via dlopen("libasound.so.2") at runtime — no
//   ALSA headers or link-time dependency, so the library builds and
//   every other feature works in audio-less containers; on a real
//   Linux box with ALSA the same .so captures/plays live audio.
// * Loopback backend: a pump thread moves samples playback-ring ->
//   capture-ring at a paced (or unpaced) rate — a virtual audio cable
//   for tests, demos and CI, exactly how the reference's no-JACK
//   "test" mode loops encode into decode (src/main.rs:480-589).
//
// Duplex model mirrors recorder.rs's half-duplex state machine: the
// caller (Python) flips between capturing (pop from capture ring) and
// playing (push to playback ring).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <dlfcn.h>
#include <pthread.h>
#include <unistd.h>

// --- ring API from tm_runtime.cc -------------------------------------
extern "C" {
size_t tm_ring_push(void* ring, const float* data, size_t len);
size_t tm_ring_pop(void* ring, float* out, size_t len);
size_t tm_ring_size(void* ring);
}

namespace {

// ---- minimal ALSA surface, resolved at runtime -----------------------
typedef void snd_pcm_t;
constexpr int kSndPcmStreamPlayback = 0;
constexpr int kSndPcmStreamCapture = 1;
constexpr int kSndPcmFormatFloatLE = 14;   // SND_PCM_FORMAT_FLOAT_LE
constexpr int kSndPcmAccessRwInterleaved = 3;

struct AlsaApi {
  void* lib = nullptr;
  int (*open)(snd_pcm_t**, const char*, int, int) = nullptr;
  int (*set_params)(snd_pcm_t*, int, int, unsigned, unsigned, int,
                    unsigned) = nullptr;
  long (*readi)(snd_pcm_t*, void*, unsigned long) = nullptr;
  long (*writei)(snd_pcm_t*, const void*, unsigned long) = nullptr;
  int (*recover)(snd_pcm_t*, int, int) = nullptr;
  int (*close)(snd_pcm_t*) = nullptr;

  bool load() {
    if (lib) return true;
    lib = dlopen("libasound.so.2", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libasound.so", RTLD_NOW | RTLD_LOCAL);
    if (!lib) return false;
    open = (decltype(open))dlsym(lib, "snd_pcm_open");
    set_params = (decltype(set_params))dlsym(lib, "snd_pcm_set_params");
    readi = (decltype(readi))dlsym(lib, "snd_pcm_readi");
    writei = (decltype(writei))dlsym(lib, "snd_pcm_writei");
    recover = (decltype(recover))dlsym(lib, "snd_pcm_recover");
    close = (decltype(close))dlsym(lib, "snd_pcm_close");
    return open && set_params && readi && writei && recover && close;
  }
};

AlsaApi g_alsa;

// ---- minimal JACK surface, resolved at runtime ------------------------
// Reference equivalent: src/device/jack.rs:17-64 (connect_system_ports)
// + the process callback registration in src/main.rs:368-378.
typedef void jack_client_t;
typedef void jack_port_t;
typedef uint32_t jack_nframes_t;
typedef int (*JackProcessCallback)(jack_nframes_t, void*);
constexpr unsigned long kJackPortIsInput = 1;
constexpr unsigned long kJackPortIsOutput = 2;
constexpr unsigned long kJackPortIsPhysical = 4;
constexpr const char* kJackAudioType = "32 bit float mono audio";

struct JackApi {
  void* lib = nullptr;
  jack_client_t* (*client_open)(const char*, int, int*) = nullptr;
  int (*client_close)(jack_client_t*) = nullptr;
  int (*set_process_callback)(jack_client_t*, JackProcessCallback,
                              void*) = nullptr;
  int (*activate)(jack_client_t*) = nullptr;
  int (*deactivate)(jack_client_t*) = nullptr;
  jack_port_t* (*port_register)(jack_client_t*, const char*, const char*,
                                unsigned long, unsigned long) = nullptr;
  void* (*port_get_buffer)(jack_port_t*, jack_nframes_t) = nullptr;
  const char** (*get_ports)(jack_client_t*, const char*, const char*,
                            unsigned long) = nullptr;
  const char* (*port_name)(const jack_port_t*) = nullptr;
  int (*connect)(jack_client_t*, const char*, const char*) = nullptr;
  void (*free_fn)(void*) = nullptr;
  unsigned (*get_sample_rate)(jack_client_t*) = nullptr;

  bool load() {
    if (lib) return true;
    lib = dlopen("libjack.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libjack.so", RTLD_NOW | RTLD_LOCAL);
    if (!lib) return false;
    client_open = (decltype(client_open))dlsym(lib, "jack_client_open");
    client_close = (decltype(client_close))dlsym(lib, "jack_client_close");
    set_process_callback = (decltype(set_process_callback))dlsym(
        lib, "jack_set_process_callback");
    activate = (decltype(activate))dlsym(lib, "jack_activate");
    deactivate = (decltype(deactivate))dlsym(lib, "jack_deactivate");
    port_register = (decltype(port_register))dlsym(lib,
                                                   "jack_port_register");
    port_get_buffer = (decltype(port_get_buffer))dlsym(
        lib, "jack_port_get_buffer");
    get_ports = (decltype(get_ports))dlsym(lib, "jack_get_ports");
    port_name = (decltype(port_name))dlsym(lib, "jack_port_name");
    connect = (decltype(connect))dlsym(lib, "jack_connect");
    free_fn = (decltype(free_fn))dlsym(lib, "jack_free");
    get_sample_rate = (decltype(get_sample_rate))dlsym(
        lib, "jack_get_sample_rate");
    return client_open && client_close && set_process_callback &&
           activate && port_register && port_get_buffer && get_ports &&
           port_name && connect && free_fn;
  }
};

JackApi g_jack;

// ---- minimal PortAudio surface, resolved at runtime -------------------
// The portable route to macOS hosts: PortAudio fronts CoreAudio there
// (and WASAPI/ALSA elsewhere), so this one backend covers the
// reference's CoreAudio-jackd setup (README.md:57-102) without any
// platform-specific code.  Same dlopen discipline as ALSA/JACK: no
// headers, no link-time dependency, absent-library hosts keep working.
typedef void PaStream;
typedef int (*PaStreamCallback)(const void*, void*, unsigned long,
                                const void*, unsigned long, void*);
constexpr unsigned long kPaFloat32 = 0x00000001;
constexpr int kPaContinue = 0;

struct PortAudioApi {
  void* lib = nullptr;
  int (*initialize)(void) = nullptr;
  int (*terminate)(void) = nullptr;
  int (*open_default)(PaStream**, int, int, unsigned long, double,
                      unsigned long, PaStreamCallback, void*) = nullptr;
  int (*start)(PaStream*) = nullptr;
  int (*stop)(PaStream*) = nullptr;
  int (*close)(PaStream*) = nullptr;

  bool load() {
    if (lib) return true;
    lib = dlopen("libportaudio.so.2", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libportaudio.so", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libportaudio.2.dylib", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libportaudio.dylib", RTLD_NOW | RTLD_LOCAL);
    if (!lib) return false;
    initialize = (decltype(initialize))dlsym(lib, "Pa_Initialize");
    terminate = (decltype(terminate))dlsym(lib, "Pa_Terminate");
    open_default = (decltype(open_default))dlsym(
        lib, "Pa_OpenDefaultStream");
    start = (decltype(start))dlsym(lib, "Pa_StartStream");
    stop = (decltype(stop))dlsym(lib, "Pa_StopStream");
    close = (decltype(close))dlsym(lib, "Pa_CloseStream");
    return initialize && terminate && open_default && start && stop &&
           close;
  }
};

PortAudioApi g_pa;

struct AudioDuplex {
  void* cap_ring;      // device -> decoder
  void* play_ring;     // encoder -> device
  unsigned rate;
  unsigned period;     // frames per chunk
  std::atomic<bool> stop{false};
  pthread_t cap_thread{};
  pthread_t play_thread{};
  snd_pcm_t* cap_pcm = nullptr;
  snd_pcm_t* play_pcm = nullptr;
  bool loopback = false;
  bool paced = true;   // loopback: move data at real-time rate
  // JACK backend state
  jack_client_t* jack = nullptr;
  jack_port_t* jack_in = nullptr;
  jack_port_t* jack_out = nullptr;
  // PortAudio backend state
  PaStream* pa_stream = nullptr;
};

// PortAudio duplex callback — same ring contract as jack_process:
// input block -> capture ring, playback ring -> output block with
// silence fill on underrun.
int pa_process(const void* input, void* output, unsigned long nframes,
               const void*, unsigned long, void* arg) {
  auto* d = (AudioDuplex*)arg;
  if (input) tm_ring_push(d->cap_ring, (const float*)input, nframes);
  if (output) {
    float* out = (float*)output;
    size_t got = tm_ring_pop(d->play_ring, out, nframes);
    if (got < nframes)
      memset(out + got, 0, (nframes - got) * sizeof(float));
  }
  return kPaContinue;
}

// The JACK real-time callback — the direct counterpart of the
// reference's process closure (src/audio/recorder.rs:35-153), with the
// AppShared mutex buffers replaced by the lock-free SPSC rings: capture
// port -> capture ring, playback ring -> output port (silence on
// underrun, like recorder.rs's Idle arm).
int jack_process(jack_nframes_t nframes, void* arg) {
  auto* d = (AudioDuplex*)arg;
  float* in = (float*)g_jack.port_get_buffer(d->jack_in, nframes);
  float* out = (float*)g_jack.port_get_buffer(d->jack_out, nframes);
  if (in) tm_ring_push(d->cap_ring, in, nframes);
  if (out) {
    size_t got = tm_ring_pop(d->play_ring, out, nframes);
    if (got < nframes)
      memset(out + got, 0, (nframes - got) * sizeof(float));
  }
  return 0;
}

// Auto-connect to the first physical ports, mirroring
// connect_system_ports (src/device/jack.rs:17-64): physical capture
// source -> our input; our output -> physical playback sink.
void jack_autoconnect(AudioDuplex* d) {
  const char** caps = g_jack.get_ports(
      d->jack, nullptr, nullptr, kJackPortIsPhysical | kJackPortIsOutput);
  if (caps) {
    if (caps[0])
      g_jack.connect(d->jack, caps[0], g_jack.port_name(d->jack_in));
    g_jack.free_fn(caps);
  }
  const char** sinks = g_jack.get_ports(
      d->jack, nullptr, nullptr, kJackPortIsPhysical | kJackPortIsInput);
  if (sinks) {
    if (sinks[0])
      g_jack.connect(d->jack, g_jack.port_name(d->jack_out), sinks[0]);
    g_jack.free_fn(sinks);
  }
}

void* capture_main(void* arg) {
  auto* d = (AudioDuplex*)arg;
  float buf[4096];
  while (!d->stop.load(std::memory_order_relaxed)) {
    long n = g_alsa.readi(d->cap_pcm, buf,
                          d->period < 4096 ? d->period : 4096);
    if (n < 0) {
      if (g_alsa.recover(d->cap_pcm, (int)n, 1) < 0) break;
      continue;
    }
    tm_ring_push(d->cap_ring, buf, (size_t)n);
  }
  return nullptr;
}

void* playback_main(void* arg) {
  auto* d = (AudioDuplex*)arg;
  float buf[4096];
  const size_t chunk = d->period < 4096 ? d->period : 4096;
  while (!d->stop.load(std::memory_order_relaxed)) {
    size_t got = tm_ring_pop(d->play_ring, buf, chunk);
    if (got == 0) {           // underrun: feed silence
      memset(buf, 0, chunk * sizeof(float));
      got = chunk;
    }
    long n = g_alsa.writei(d->play_pcm, buf, got);
    if (n < 0 && g_alsa.recover(d->play_pcm, (int)n, 1) < 0) break;
  }
  return nullptr;
}

void* loopback_main(void* arg) {
  auto* d = (AudioDuplex*)arg;
  float buf[4096];
  const size_t chunk = d->period < 4096 ? d->period : 4096;
  const useconds_t sleep_us =
      d->paced ? (useconds_t)(1e6 * chunk / d->rate) : 0;
  while (!d->stop.load(std::memory_order_relaxed)) {
    size_t got = tm_ring_pop(d->play_ring, buf, chunk);
    if (got) tm_ring_push(d->cap_ring, buf, got);
    if (sleep_us) usleep(sleep_us);
    else if (!got) usleep(200);  // idle; avoid a hot spin
  }
  return nullptr;
}

}  // namespace

extern "C" {

int tm_audio_alsa_available(void) { return g_alsa.load() ? 1 : 0; }

// libjack is present (a server may still not be running; open fails
// cleanly in that case).
int tm_audio_jack_available(void) { return g_jack.load() ? 1 : 0; }

// libportaudio is present (open can still fail if no device).
int tm_audio_portaudio_available(void) { return g_pa.load() ? 1 : 0; }

// Open a duplex stream. backend: 0 = ALSA (device name, e.g.
// "default"), 1 = loopback paced at `rate`, 2 = loopback unpaced
// (tests), 3 = JACK (device = client name; auto-connects to the first
// physical ports like src/device/jack.rs:17-64), 4 = PortAudio default
// duplex device (macOS/CoreAudio, WASAPI, ...). Returns an opaque
// handle or NULL.
void* tm_audio_open(const char* device, int backend, unsigned rate,
                    unsigned period, void* capture_ring,
                    void* playback_ring) {
  auto* d = new AudioDuplex();
  d->cap_ring = capture_ring;
  d->play_ring = playback_ring;
  d->rate = rate;
  d->period = period ? period : 256;

  if (backend == 0) {
    if (!g_alsa.load()) { delete d; return nullptr; }
    if (g_alsa.open(&d->cap_pcm, device, kSndPcmStreamCapture, 0) < 0 ||
        g_alsa.set_params(d->cap_pcm, kSndPcmFormatFloatLE,
                          kSndPcmAccessRwInterleaved, 1, rate, 1,
                          500000) < 0) {
      delete d; return nullptr;
    }
    if (g_alsa.open(&d->play_pcm, device, kSndPcmStreamPlayback, 0) < 0 ||
        g_alsa.set_params(d->play_pcm, kSndPcmFormatFloatLE,
                          kSndPcmAccessRwInterleaved, 1, rate, 1,
                          500000) < 0) {
      g_alsa.close(d->cap_pcm);
      delete d; return nullptr;
    }
    pthread_create(&d->cap_thread, nullptr, capture_main, d);
    pthread_create(&d->play_thread, nullptr, playback_main, d);
    return d;
  }

  if (backend == 3) {
    if (!g_jack.load()) { delete d; return nullptr; }
    int status = 0;
    d->jack = g_jack.client_open(device && *device ? device : "trackmaker",
                                 0 /* JackNullOption */, &status);
    if (!d->jack) { delete d; return nullptr; }
    d->jack_in = g_jack.port_register(d->jack, "input", kJackAudioType,
                                      kJackPortIsInput, 0);
    d->jack_out = g_jack.port_register(d->jack, "output", kJackAudioType,
                                       kJackPortIsOutput, 0);
    if (!d->jack_in || !d->jack_out ||
        g_jack.set_process_callback(d->jack, jack_process, d) != 0 ||
        g_jack.activate(d->jack) != 0) {
      g_jack.client_close(d->jack);
      delete d;
      return nullptr;
    }
    jack_autoconnect(d);
    if (g_jack.get_sample_rate) d->rate = g_jack.get_sample_rate(d->jack);
    return d;
  }

  if (backend == 4) {
    if (!g_pa.load() || g_pa.initialize() != 0) { delete d; return nullptr; }
    if (g_pa.open_default(&d->pa_stream, 1, 1, kPaFloat32, (double)rate,
                          d->period, pa_process, d) != 0 ||
        g_pa.start(d->pa_stream) != 0) {
      if (d->pa_stream) g_pa.close(d->pa_stream);
      g_pa.terminate();
      delete d;
      return nullptr;
    }
    return d;
  }

  d->loopback = true;
  d->paced = (backend == 1);
  pthread_create(&d->cap_thread, nullptr, loopback_main, d);
  return d;
}

void tm_audio_close(void* handle) {
  auto* d = (AudioDuplex*)handle;
  if (!d) return;
  if (d->pa_stream) {
    g_pa.stop(d->pa_stream);
    g_pa.close(d->pa_stream);
    g_pa.terminate();
    delete d;
    return;
  }
  if (d->jack) {
    if (g_jack.deactivate) g_jack.deactivate(d->jack);
    g_jack.client_close(d->jack);
    delete d;
    return;
  }
  d->stop.store(true, std::memory_order_relaxed);
  pthread_join(d->cap_thread, nullptr);
  if (!d->loopback) pthread_join(d->play_thread, nullptr);
  if (d->cap_pcm) g_alsa.close(d->cap_pcm);
  if (d->play_pcm) g_alsa.close(d->play_pcm);
  delete d;
}

}  // extern "C"
