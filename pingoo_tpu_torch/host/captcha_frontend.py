"""The captcha challenge frontend — built-app parity.

The reference embeds a compiled Preact/vite app (captcha/src/index.tsx,
served via captcha.rs serve_captcha / serve_asset). This module is the
same app re-derived without a JS toolchain: a hand-compiled vanilla
rendering of the identical UX state machine —

  checkbox -> 'Verifying...' + spinner -> GET /api/init (retried 3x,
  200 ms apart) -> WebCrypto SHA-256 proof of work (nonce starts at 1)
  -> POST /api/verify -> 'Success!' -> location.reload() after 500 ms
  (reload happens on failure too, exactly like index.tsx:72), with the
  reference's error copy when anything throws.

The page shell mirrors index.html + index.css (dark/light color-scheme,
domain headline, bordered checkbox card), and the script ships as a
separate /__pingoo/captcha/assets/index.js asset like the vite build.
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
  <head>
    <meta charset="UTF-8" />
    <meta name="viewport" content="width=device-width, initial-scale=1.0" />
    <title>Security Verification</title>
    <style>
:root {
  font-family: system-ui, Avenir, Helvetica, Arial, sans-serif;
  line-height: 1.5; font-weight: 400;
  color-scheme: light dark;
  color: rgba(255, 255, 255, 0.87); background-color: #242424;
  font-synthesis: none; text-rendering: optimizeLegibility;
  -webkit-font-smoothing: antialiased;
}
@media (prefers-color-scheme: light) {
  :root { color: #213547; background-color: #ffffff; }
}
body { margin: 0; display: flex; place-items: center;
       min-width: 320px; min-height: 100vh; }
#pingoo-captcha { width: 100%; }
.wrap { display: flex; justify-content: center; width: 100%; }
.col { display: flex; flex-direction: column; max-width: 36rem;
       padding: 1.25rem; margin-top: -20vh; }
.col > * + * { margin-top: 2rem; }
h1 { font-size: 1.5rem; font-weight: 700; margin: 0; }
h2 { font-size: 1.25rem; font-weight: 500; margin: 0; }
.box { display: flex; flex-direction: column; width: fit-content;
       border: 1px solid #8884; border-radius: 0.375rem;
       padding: 1.25rem; align-items: center; }
.row { display: flex; align-items: center; width: 100%; }
.row p { margin: 0 0 0 1rem; }
input[type=checkbox] { width: 2rem; height: 2rem; cursor: pointer; }
.error { font-weight: 500; color: #ef4444; }
.spinner { height: 2rem; width: 2rem; color: #6b7280; }
.spinner svg { animation: spin 1s linear infinite; }
@keyframes spin { to { transform: rotate(360deg); } }
.hidden { display: none; }
    </style>
  </head>
  <body>
    <div id="pingoo-captcha">
      <div class="wrap"><div class="col">
        <h1 id="domain"></h1>
        <h2>Verify you are human by completing the action below.</h2>
        <div class="box"><div class="row">
          <input id="cb" type="checkbox" />
          <span id="spin" class="spinner hidden">
            <svg xmlns="http://www.w3.org/2000/svg" fill="none"
                 viewBox="0 0 24 24">
              <circle style="opacity:.25" cx="12" cy="12" r="10"
                      stroke="currentColor" stroke-width="4"></circle>
              <path style="opacity:.75" fill="currentColor"
                    d="M4 12a8 8 0 018-8V0C5.373 0 0 5.373 0 12h4zm2
                       5.291A7.962 7.962 0 014 12H0c0 3.042 1.135 5.824 3
                       7.938l3-2.647z"></path>
            </svg>
          </span>
          <p id="message">Click on the checkbox</p>
        </div></div>
        <p id="error" class="error hidden">Oops! Something went wrong.
        Please reload the page and ensure that your cookies are
        enabled.</p>
      </div></div>
    </div>
    <script src="/__pingoo/captcha/assets/index.js"></script>
  </body>
</html>
"""

APP_JS = """'use strict';
(function () {
  var checkboxLoading = false;
  var verified = false;
  var cb = document.getElementById('cb');
  var spin = document.getElementById('spin');
  var message = document.getElementById('message');
  var errorEl = document.getElementById('error');
  document.getElementById('domain').textContent = window.location.hostname;

  function renderMessage() {
    if (verified) { message.textContent = 'Success!'; }
    else if (checkboxLoading) { message.textContent = 'Verifying...'; }
    else { message.textContent = 'Click on the checkbox'; }
    cb.classList.toggle('hidden', checkboxLoading);
    spin.classList.toggle('hidden', !checkboxLoading);
    cb.checked = verified;
  }

  function uint8ArrayToHex(data) {
    var hex = '';
    for (var i = 0; i < data.length; i++) {
      hex += data[i].toString(16).padStart(2, '0');
    }
    return hex;
  }

  async function retry(fn, options) {
    var attempts = (options && options.attempts) || 3;
    var delay = (options && options.delay) || 100;
    for (var i = 0; i < attempts; i++) {
      try { return await fn(); }
      catch (err) {
        if (i < attempts - 1) {
          await new Promise(function (r) { setTimeout(r, delay); });
        } else { throw err; }
      }
    }
  }

  async function proofOfWork(challenge, difficulty) {
    var nonce = 0;
    var hash = '';
    var target = '0'.repeat(difficulty);
    var enc = new TextEncoder();
    do {
      nonce++;
      hash = uint8ArrayToHex(new Uint8Array(await window.crypto.subtle
        .digest('SHA-256', enc.encode(challenge + nonce))));
    } while (hash.substring(0, difficulty) !== target);
    return { nonce: nonce.toString(10), hash: hash };
  }

  async function onCheckboxClicked(event) {
    if (event) event.preventDefault();
    if (checkboxLoading || verified) return;
    errorEl.classList.add('hidden');
    checkboxLoading = true;
    renderMessage();
    try {
      var settings = await retry(async function () {
        var initRes = await fetch('/__pingoo/captcha/api/init');
        if (initRes.status !== 200) { throw new Error(await initRes.text()); }
        return await initRes.json();
      }, { delay: 200 });
      var result = await proofOfWork(settings.challenge, settings.difficulty);
      var verifyRes = await fetch('/__pingoo/captcha/api/verify', {
        method: 'POST',
        headers: { 'Content-Type': 'application/json' },
        body: JSON.stringify(result),
      });
      checkboxLoading = false;
      if (verifyRes.status === 200) { verified = true; }
      renderMessage();
      // reload to allow access (or redo the challenge on failure)
      setTimeout(function () { location.reload(); }, 500);
    } catch (err) {
      console.error(err);
      errorEl.classList.remove('hidden');
      checkboxLoading = false;
      renderMessage();
    }
  }

  cb.addEventListener('click', onCheckboxClicked);
  renderMessage();
})();
"""
